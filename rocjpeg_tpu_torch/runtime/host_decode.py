"""Host entropy decode through the native library.

The host-entropy path of the port (``device_entropy='off'``, and the groups
the device packer refuses) decodes coefficients with the C++ library bound
in :mod:`.native`. There is no pure-Python route here: ``core/entropy.py``
is the oracle the tests hold the library against, and a library that cannot
be built raises when it is first needed.
"""

from __future__ import annotations

import concurrent.futures
import os
from typing import List, Sequence

import numpy as np

from ..core.bitstream import JpegStreamParams
from . import native


def decode_coefficients(params: JpegStreamParams) -> List[np.ndarray]:
    """Entropy-decode one stream into per-component natural-order coefficient
    planes (blocks_h, blocks_w, 64) int16."""
    return native.decode_scan(params)


def decode_coefficients_batch(
        params_list: Sequence[JpegStreamParams]) -> List[List[np.ndarray]]:
    """Entropy-decode a batch over a thread pool (the C++ decoder releases
    the GIL, and additionally splits restart segments across threads)."""
    if len(params_list) <= 1:
        return [native.decode_scan(p) for p in params_list]
    workers = min(len(params_list), os.cpu_count() or 1)
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        return list(pool.map(native.decode_scan, params_list))
