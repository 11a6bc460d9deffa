"""Huffman decode tables and static group geometry for the wave kernel.

Ported from ``rocjpeg_tpu/ops/device_entropy.py`` (``build_canonical_tables``,
``DeviceScanTables``, ``GroupGeometry``, ``max_steps_bound``) with their
numpy semantics unchanged; that module imports jax, this one does not.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from rocjpeg_tpu.core.bitstream import JpegStreamParams
from rocjpeg_tpu.core.zigzag import ZIGZAG_ORDER
from rocjpeg_tpu.status import RocJpegError, Status

# Per-table value capacity: DC tables hold <= 16 symbols, AC <= 162; the
# packed layout allots these byte offsets to (dc0, dc1, ac0, ac1) in a bank.
VAL_OFFS = (0, 16, 32, 194)
VAL_TOTAL = 356
VAL_WORDS = (VAL_TOTAL + 3) // 4  # 89
MAX_BANKS = 4

# Natural index of the k-th zigzag coefficient (ITU-T T.81 Figure 5).
ZIGZAG = tuple(int(z) for z in ZIGZAG_ORDER)


def build_canonical_tables(bits: np.ndarray, values: np.ndarray):
    """Canonical Huffman decode tables (T.81 Annex F.2.2.3): per code length
    1..16, maxcode+1 (0 when the length has no codes) and
    base15 = (valptr - mincode) mod 2^15, so that
    value_index = (code + base15) mod 2^15."""
    maxc1 = np.zeros(16, np.uint32)
    base15 = np.zeros(16, np.uint32)
    code = 0
    k = 0
    for length in range(1, 17):
        n = int(bits[length - 1])
        if n:
            base15[length - 1] = (k - code) & 0x7FFF
            maxc1[length - 1] = code + n
            code += n
            k += n
        code <<= 1
    return maxc1, base15


@dataclasses.dataclass
class DeviceScanTables:
    """Packed decode tables for the (dc0, dc1, ac0, ac1) table slots of
    ``n_banks`` table banks (one bank per distinct table set in a group;
    lanes carry a bank index).

    lentab: (4 * n_banks, 16) uint32, (maxcode+1) << 15 | base15 per length.
    values: (n_banks * VAL_WORDS,) uint32, 4 symbol bytes per word, tables
            at VAL_OFFS byte offsets within each bank.
    """
    lentab: np.ndarray
    values: np.ndarray
    digest: bytes
    n_banks: int = 1

    @classmethod
    def from_params(cls, p: JpegStreamParams) -> "DeviceScanTables":
        lentab = np.zeros((4, 16), np.uint32)
        vals = np.zeros(VAL_TOTAL, np.uint8)
        for slot in range(4):
            which, tid = ("dc", slot) if slot < 2 else ("ac", slot - 2)
            t = p.huffman_tables[tid] if tid < len(p.huffman_tables) else None
            if t is None or not p.load_huffman_table[tid]:
                continue
            if which == "dc":
                bits, values = t.num_dc_codes, t.dc_values
            else:
                bits, values = t.num_ac_codes, t.ac_values
            maxc1, base15 = build_canonical_tables(bits, values)
            lentab[slot] = (maxc1 << 15) | base15
            off = VAL_OFFS[slot]
            cap = (VAL_OFFS[slot + 1] if slot < 3 else VAL_TOTAL) - off
            n = min(len(values), cap)
            vals[off:off + n] = values[:n]
        packed = (vals[0::4].astype(np.uint32)
                  | (vals[1::4].astype(np.uint32) << 8)
                  | (vals[2::4].astype(np.uint32) << 16)
                  | (vals[3::4].astype(np.uint32) << 24))
        digest = lentab.tobytes() + packed.tobytes()
        return cls(lentab, packed, digest, 1)

    @classmethod
    def from_params_banked(cls, params_list, max_banks: int = MAX_BANKS):
        """Dedup the group's table sets into banks. Returns
        (tables, bank_of_image int32 (B,)); raises
        RocJpegError(JPEG_NOT_SUPPORTED) past ``max_banks`` distinct sets
        (callers fall back to the host path)."""
        banks = []
        digests = {}
        bank_of = np.zeros(len(params_list), np.int32)
        for i, p in enumerate(params_list):
            t = cls.from_params(p)
            b = digests.get(t.digest)
            if b is None:
                b = len(banks)
                if b >= max_banks:
                    raise RocJpegError(
                        Status.JPEG_NOT_SUPPORTED,
                        f"more than {max_banks} Huffman table sets in group")
                digests[t.digest] = b
                banks.append(t)
            bank_of[i] = b
        lentab = np.concatenate([t.lentab for t in banks])
        values = np.concatenate([t.values for t in banks])
        return cls(lentab, values, b"|".join(t.digest for t in banks),
                   len(banks)), bank_of


@dataclasses.dataclass(frozen=True)
class GroupGeometry:
    """Static decode geometry of one shape group.

    Per scan-block slot (position of a block within one MCU, in scan
    order — e.g. 4:2:0: Y00 Y01 Y10 Y11 U V):
      flat_off[s]  = component plane base + dy*bw + dx  (block offset)
      row_step[s]  = v_sampling * bw   (flat-block stride per MCU row)
      col_step[s]  = h_sampling        (flat-block stride per MCU column)
      dc_slot[s]/ac_slot[s] = Huffman table slot (0..3)
      comp_of_slot[s] = component index (DC predictor)
    """
    batch: int
    mcus_w: int
    flat_off: Tuple[int, ...]
    row_step: Tuple[int, ...]
    col_step: Tuple[int, ...]
    dc_slot: Tuple[int, ...]
    ac_slot: Tuple[int, ...]
    comp_of_slot: Tuple[int, ...]
    ncomp: int
    blocks_w: Tuple[int, ...]
    comp_base: Tuple[int, ...]
    total_blocks: int           # per image, all components

    @classmethod
    def from_params(cls, p: JpegStreamParams, batch: int) -> "GroupGeometry":
        ncomp = len(p.scan_components)
        interleaved = ncomp > 1
        blocks_w, comp_base = [], []
        base = 0
        for ci in range(len(p.components)):
            bh, bw = p.component_block_dims(ci)
            if not interleaved:
                bh = (p.picture_height + 7) // 8
                bw = (p.picture_width + 7) // 8
            blocks_w.append(bw)
            comp_base.append(base)
            base += bh * bw
        flat_off, row_step, col_step = [], [], []
        dc_slot, ac_slot, comp_of_slot = [], [], []
        if interleaved:
            for ci in range(ncomp):
                fc = p.components[ci]
                sc = p.scan_components[ci]
                for v in range(fc.v_sampling_factor):
                    for u in range(fc.h_sampling_factor):
                        flat_off.append(comp_base[ci] + v * blocks_w[ci] + u)
                        row_step.append(fc.v_sampling_factor * blocks_w[ci])
                        col_step.append(fc.h_sampling_factor)
                        dc_slot.append(sc.dc_table_selector)
                        ac_slot.append(sc.ac_table_selector + 2)
                        comp_of_slot.append(ci)
            mcus_w = p.mcus_per_row
        else:
            sc = p.scan_components[0]
            flat_off, row_step, col_step = [0], [blocks_w[0]], [1]
            dc_slot = [sc.dc_table_selector]
            ac_slot = [sc.ac_table_selector + 2]
            comp_of_slot = [0]
            mcus_w = (p.picture_width + 7) // 8
        return cls(batch=batch, mcus_w=mcus_w,
                   flat_off=tuple(flat_off), row_step=tuple(row_step),
                   col_step=tuple(col_step), dc_slot=tuple(dc_slot),
                   ac_slot=tuple(ac_slot), comp_of_slot=tuple(comp_of_slot),
                   ncomp=ncomp, blocks_w=tuple(blocks_w),
                   comp_base=tuple(comp_base), total_blocks=base)

    def comp_dims(self):
        """Per-component (blocks_h, blocks_w) of the flat coefficient
        tensor's planes."""
        ends = self.comp_base[1:] + (self.total_blocks,)
        return tuple(((end - base) // bw, bw) for base, end, bw
                     in zip(self.comp_base, ends, self.blocks_w))

    def with_planes(self, dims) -> "GroupGeometry":
        """This geometry with its plane layout replaced by per-component
        (blocks_h, blocks_w) ``dims`` — the host decoder's MCU-padded
        planes, which can exceed the scan's tight planes for a
        single-component scan with sampling factors above 1."""
        comp_base, base = [], 0
        for bh, bw in dims:
            comp_base.append(base)
            base += bh * bw
        return dataclasses.replace(
            self, blocks_w=tuple(bw for _, bw in dims),
            comp_base=tuple(comp_base), total_blocks=base)


def max_steps_bound(geom: GroupGeometry, packed) -> int:
    """Hard per-lane symbol bound: every symbol of a legit lane consumes
    >= 1 bit of real payload, and a block yields at most 65 symbols
    (1 DC + up to 63 AC + EOB). Virtual-restart packs carry the exact
    per-lane symbol counts from the index walk."""
    nslots = len(geom.flat_off)
    block_bound = int(packed.mcu_count.max()) * nslots * 65
    bits_bound = packed.max_seg_bits + 64
    bound = min(block_bound, bits_bound)
    if packed.max_lane_syms:
        bound = min(bound, packed.max_lane_syms)
    return max(256, min(-(-bound // 256) * 256, block_bound))
