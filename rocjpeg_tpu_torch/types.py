"""Decode capability spec of the GPU port.

The port's analog of ``rocjpeg_tpu.types.TpuDecodeSpec`` (itself the analog
of the reference's per-arch ``VcnJpegSpec``): resolution limits and the
batch-chunk width ``decode_batched`` uses.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GpuDecodeSpec:
    """Per-device decode capability spec.

    ``num_decode_lanes`` is the batch-chunk width of ``decode_batched``
    (the reference chunks by ``num_jpeg_cores``). 16 is a default, the
    bench's batch, not a measurement: the width that saturates one H100
    has not been measured yet.
    """

    name: str = "cuda"
    num_decode_lanes: int = 16
    min_width: int = 64  # reference min 64x64
    min_height: int = 64
    max_width: int = 16384
    max_height: int = 16384
