"""Carry parser and packer state across to the port.

``tables_from_numpy`` / ``packed_from_numpy`` work on the JAX package's
``DeviceScanTables`` / ``PackedDense`` and on the port's own
(``ops.tables`` / ``ops.pack``) alike — they share field names — so the
tests can feed the JAX packer's output to the port's kernels and check the
kernels and the packer separately; the main path stages its arrays with
``ops.staging.Stager`` instead. uint32 arrays travel as int32 tensors
with the same bits (torch has few uint32 ops). ``params_from_jax`` copies
the JAX parser's stream parameters into the port's own class, attribute by
attribute: nothing here imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .core import bitstream as bs
from .types import ChromaSubsampling


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


def params_from_jax(jax_params) -> bs.JpegStreamParams:
    """The JAX parser's ``JpegStreamParams`` as the port's own, field by
    field (arrays copied), so one parse can feed both packages."""
    p = jax_params
    return bs.JpegStreamParams(
        picture_width=int(p.picture_width),
        picture_height=int(p.picture_height),
        num_components=int(p.num_components),
        components=[bs.FrameComponent(
            component_id=int(c.component_id),
            h_sampling_factor=int(c.h_sampling_factor),
            v_sampling_factor=int(c.v_sampling_factor),
            quantiser_table_selector=int(c.quantiser_table_selector))
            for c in p.components],
        quantiser_tables=np.array(p.quantiser_tables, np.uint8),
        load_quantiser_table=np.array(p.load_quantiser_table, np.uint8),
        huffman_tables=[bs.HuffmanTableSet(
            num_dc_codes=np.array(t.num_dc_codes, np.uint8),
            dc_values=np.array(t.dc_values, np.uint8),
            num_ac_codes=np.array(t.num_ac_codes, np.uint8),
            ac_values=np.array(t.ac_values, np.uint8))
            for t in p.huffman_tables],
        load_huffman_table=np.array(p.load_huffman_table, np.uint8),
        scan_components=[bs.ScanComponent(
            component_selector=int(c.component_selector),
            dc_table_selector=int(c.dc_table_selector),
            ac_table_selector=int(c.ac_table_selector))
            for c in p.scan_components],
        restart_interval=int(p.restart_interval),
        num_mcus=int(p.num_mcus),
        slice_data=bytes(p.slice_data),
        chroma_subsampling=ChromaSubsampling(int(p.chroma_subsampling)))
