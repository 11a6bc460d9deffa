"""Device mesh for multi-device decode.

Counterpart of ``rocjpeg_tpu/dist/mesh.py``: a ``('data', 'space')`` grid
of devices. ``data`` is the batch axis: each row decodes a contiguous
shard of every call's images. ``space`` is the JAX package's within-image
axis, which there only lays out block rows of one XLA program; here it
decides how many rows the devices make and splits nothing inside an
image.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from .. import api
from ..status import RocJpegError, Status

AXIS_NAMES = ("data", "space")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, space)`` grid of ``torch.device``s, one tuple a row."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = AXIS_NAMES

    @property
    def shape(self) -> dict:
        """``{"data": rows, "space": devices a row}``."""
        return {"data": len(self.devices), "space": len(self.devices[0])}


def make_mesh(n_devices: Optional[int] = None, space: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ``('data', 'space')`` mesh over ``devices`` (each a
    ``"cpu"`` or ``"cuda[:n]"`` string, a ``torch.device`` or a CUDA
    index; one may appear more than once), by default every CUDA device;
    ``n_devices`` keeps the first that many. Without CUDA and without
    ``devices``, or with a CUDA device that is absent, raises
    RocJpegError(NOT_INITIALIZED), as ``api.Decoder`` does; a device count
    that ``space`` does not divide raises ValueError."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RocJpegError(Status.NOT_INITIALIZED,
                               "no CUDA device is available")
        devices = range(torch.cuda.device_count())
    devs = [api._resolve_device(d, 0) for d in devices]
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if space < 1 or n == 0 or n % space:
        raise ValueError(f"{n} devices not divisible by space={space}")
    return Mesh(tuple(tuple(devs[r * space:(r + 1) * space])
                      for r in range(n // space)))
