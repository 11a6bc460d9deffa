"""Carry packer state from numpy to the port's device tensors.

Works on the JAX package's ``DeviceScanTables`` / ``PackedDense`` and on
the port's own (``ops.tables`` / ``ops.pack``) alike — they share field
names — so the tests can feed the JAX packer's output to the port's
kernels and check the kernels and the packer separately. uint32 arrays
travel as int32 tensors with the same bits (torch has few uint32 ops).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if a.dtype != np.int32:
        raise TypeError(f"expected an int32/uint32 array, got {a.dtype}")
    return torch.from_numpy(a).to(device)


@dataclasses.dataclass
class DevicePacked:
    """One group's packed lanes on the device (see ops.pack.PackedDense)."""
    dense: torch.Tensor        # (W,) int32 word stream
    word_off: torch.Tensor     # (n_lanes,) int32
    img_base: torch.Tensor
    mcu_start: torch.Tensor
    mcu_count: torch.Tensor
    lane_bank: torch.Tensor
    n_words: int
    dc_flat: Optional[torch.Tensor] = None      # (n_lanes, 3) int32
    lane_of_mcu: Optional[torch.Tensor] = None  # (B, total_mcus) int32


def tables_from_numpy(tables, device):
    """DeviceScanTables -> (lentab (4 * n_banks, 16), values
    (n_banks * 89,)), both int32 tensors on ``device``."""
    return (_to_device(tables.lentab, device),
            _to_device(tables.values, device))


def packed_from_numpy(packed, dc_flat, lane_of_mcu, device) -> DevicePacked:
    """PackedDense (+ the virtual-restart dc_flat / lane_of_mcu, or None)
    -> DevicePacked on ``device``."""
    lane_bank = (packed.lane_bank if packed.lane_bank is not None
                 else np.zeros(packed.n_lanes, np.int32))
    return DevicePacked(
        dense=_to_device(packed.dense, device),
        word_off=_to_device(packed.word_off, device),
        img_base=_to_device(packed.img_base, device),
        mcu_start=_to_device(packed.mcu_start, device),
        mcu_count=_to_device(packed.mcu_count, device),
        lane_bank=_to_device(lane_bank, device),
        n_words=int(packed.n_words),
        dc_flat=None if dc_flat is None else _to_device(dc_flat, device),
        lane_of_mcu=(None if lane_of_mcu is None
                     else _to_device(lane_of_mcu, device)))
