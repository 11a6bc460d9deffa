"""Host entropy decode through the native library.

The host-entropy path of the port (``device_entropy='off'``, and the groups
the device packer refuses) decodes coefficients with the C++ library bound
in :mod:`.native`. There is no pure-Python route here: ``core/entropy.py``
is the oracle the tests hold the library against, and a library that cannot
be built raises when it is first needed.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..core.bitstream import JpegStreamParams
from ..ops import staging
from . import native


def decode_coefficients(params: JpegStreamParams) -> List[np.ndarray]:
    """Entropy-decode one stream into per-component natural-order coefficient
    planes (blocks_h, blocks_w, 64) int16."""
    return native.decode_scan(params)


def decode_coefficients_batch(
        params_list: Sequence[JpegStreamParams]) -> List[List[np.ndarray]]:
    """Entropy-decode a batch on the process's packer pool
    (``ops.staging.pack_pool``: the C++ decoder releases the GIL, and
    additionally splits restart segments across threads of its own)."""
    return staging.map_jobs(native.decode_scan, params_list)
