"""K1 — the wave entropy decode: wrapper, plain PyTorch version, launch count.

Every lane (a real or virtual restart segment) of a decode group decodes
its canonical-Huffman symbols into the group's flat natural-order int16
coefficient tensor (B * total_blocks * 64,), and reports a per-lane error
flag. The CUDA kernel is ``csrc/wave.cu``, the port of
``rocjpeg_tpu/kernels/wave_pallas.py`` ``build_wave_kernel``.

On a CPU tensor :func:`wave_decode` runs :func:`wave_decode_reference`; on a
CUDA tensor it launches the kernel or raises. The kernel writes whole 8x8
blocks and owns the zeroes of its output, which is therefore allocated
uninitialised: every block belongs to exactly one lane's MCU range (the
packer's contract), a lane that stops early zero-fills the rest of its
range, and the kernel zero-fills the whole tensor first when the lanes do
not cover every MCU of the group (an ROI pack).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.tables import MAX_BANKS, VAL_OFFS, VAL_TOTAL, VAL_WORDS, ZIGZAG
from ..status import RocJpegError, Status
from . import build

launches = 0  # kernel launches; chip_smoke.py resets and reads it

_MAX_SLOTS = 10
_M32 = 0xFFFFFFFF


def _geom_rows(geom):
    return (geom.flat_off, geom.row_step, geom.col_step, geom.dc_slot,
            geom.ac_slot, geom.comp_of_slot)


def _check_inputs(dense, word_off, img_base, mcu_start, mcu_count,
                  lane_bank, lentab, values, geom):
    n_lanes = word_off.shape[0]
    for name, t in (("dense", dense), ("word_off", word_off),
                    ("img_base", img_base), ("mcu_start", mcu_start),
                    ("mcu_count", mcu_count), ("lentab", lentab),
                    ("values", values)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise RocJpegError(Status.INVALID_PARAMETER,
                               f"{name} must be a contiguous int32 tensor")
        if t.device != dense.device:
            raise RocJpegError(Status.INVALID_PARAMETER,
                               f"{name} is on {t.device}, not {dense.device}")
    for t in (img_base, mcu_start, mcu_count):
        if t.shape != (n_lanes,):
            raise RocJpegError(Status.INVALID_PARAMETER,
                               "lane arrays must share one (n_lanes,) shape")
    n_banks = lentab.shape[0] // 4
    if (lentab.shape != (4 * n_banks, 16) or not 1 <= n_banks <= MAX_BANKS
            or values.shape != (n_banks * VAL_WORDS,)):
        raise RocJpegError(Status.INVALID_PARAMETER,
                           "lentab/values do not describe 1..4 table banks")
    if n_banks > 1 and (lane_bank is None or lane_bank.shape != (n_lanes,)
                        or lane_bank.dtype != torch.int32
                        or lane_bank.device != dense.device
                        or not lane_bank.is_contiguous()):
        raise RocJpegError(Status.INVALID_PARAMETER,
                           "a banked group needs an int32 lane_bank")
    if not 1 <= len(geom.flat_off) <= _MAX_SLOTS or geom.ncomp > 3:
        raise RocJpegError(Status.JPEG_NOT_SUPPORTED,
                           "MCU layout beyond 10 blocks or 3 components")
    if dense.numel() == 0:
        raise RocJpegError(Status.INVALID_PARAMETER, "empty word stream")
    return n_lanes, n_banks


def _group_mcus(geom) -> int:
    """MCUs in the whole group when every block of the output belongs to an
    MCU of the scan, else -1 (a scan without some component of the frame
    leaves that component's blocks to no lane: the kernel then zero-fills
    the output first, whatever the lanes cover)."""
    nslots = len(geom.flat_off)
    if len(geom.comp_base) != geom.ncomp or geom.total_blocks % nslots:
        return -1
    return geom.batch * (geom.total_blocks // nslots)


def wave_decode(dense, word_off, img_base, mcu_start, mcu_count, lane_bank,
                lentab, values, geom, n_words: int, max_steps: int):
    """Decode every lane of one group.

    dense: (W,) int32 — the big-endian word stream (uint32 bits);
    word_off/img_base/mcu_start/mcu_count: (n_lanes,) int32;
    lane_bank: (n_lanes,) int32 table bank per lane, read only when
    lentab holds more than one bank (may be None then);
    lentab: (4 * n_banks, 16) int32; values: (n_banks * 89,) int32;
    geom: ops.tables.GroupGeometry; n_words: word budget per lane;
    max_steps: symbols per lane at most.

    Returns (coeffs_flat int16 (geom.batch * geom.total_blocks * 64,),
    err bool (n_lanes,))."""
    global launches
    n_lanes, n_banks = _check_inputs(dense, word_off, img_base, mcu_start,
                                     mcu_count, lane_bank, lentab, values,
                                     geom)
    if dense.device.type == "cpu":
        return wave_decode_reference(dense, word_off, img_base, mcu_start,
                                     mcu_count, lane_bank, lentab, values,
                                     geom, n_words, max_steps)
    if dense.device.type != "cuda":
        raise RocJpegError(Status.INVALID_PARAMETER,
                           f"unsupported device {dense.device}")
    lib = build.library()
    out_size = geom.batch * geom.total_blocks * 64
    out = torch.empty(out_size, dtype=torch.int16, device=dense.device)
    err = torch.empty(n_lanes, dtype=torch.bool, device=dense.device)
    lut = torch.empty(max(n_banks * 4 * lib.rjt_wave_lut_size(), 8),
                      dtype=torch.int16, device=dense.device)
    geom_tab = np.ascontiguousarray(_geom_rows(geom), dtype=np.int32)
    stream = torch.cuda.current_stream(dense.device).cuda_stream
    rc = lib.rjt_wave_decode(
        dense.data_ptr(), dense.numel(), word_off.data_ptr(),
        img_base.data_ptr(), mcu_start.data_ptr(), mcu_count.data_ptr(),
        lane_bank.data_ptr() if n_banks > 1 else None, n_lanes,
        lentab.data_ptr(), values.data_ptr(), n_banks,
        geom_tab.ctypes.data, len(geom.flat_off), geom.mcus_w, n_words,
        max_steps, _group_mcus(geom), out_size, out.data_ptr(),
        err.data_ptr(), lut.data_ptr(), stream)
    build.check(rc, "rjt_wave_decode")
    launches += 1
    return out, err


def _wrap(x, bits: int):
    """Two's-complement wrap of an int64 tensor to ``bits`` bits."""
    half = 1 << (bits - 1)
    return ((x + half) & ((1 << bits) - 1)) - half


def wave_decode_reference(dense, word_off, img_base, mcu_start, mcu_count,
                          lane_bank, lentab, values, geom, n_words: int,
                          max_steps: int):
    """Plain PyTorch version of :func:`wave_decode`: all lanes step in
    lockstep, one symbol per step, in int64 arithmetic with explicit 32-bit
    masks (torch has few uint32 ops). Same signature and results."""
    dev = dense.device
    i64 = torch.int64

    def t(xs):
        return torch.as_tensor(np.asarray(xs, np.int64), device=dev)

    n_lanes = word_off.shape[0]
    n_banks = lentab.shape[0] // 4
    nrows = 4 * n_banks
    out_size = geom.batch * geom.total_blocks * 64
    dense64 = dense.to(i64) & _M32
    n_dense = dense64.shape[0]
    lent = lentab.to(i64) & _M32                     # (4 * n_banks, 16)
    maxc1_t, base15_t = lent >> 15, lent & 0x7FFF
    vals = values.to(i64) & _M32
    flat_off, row_step, col_step, dc_slot, ac_slot, comp_of = (
        t(r) for r in _geom_rows(geom))
    zig = t(ZIGZAG)
    shifts = 31 - torch.arange(16, dtype=i64, device=dev)
    bank = (lane_bank.to(i64) if n_banks > 1
            else torch.zeros(n_lanes, dtype=i64, device=dev))
    woff = word_off.to(i64)
    base_img = img_base.to(i64)
    mx = mcu_start.to(i64) % geom.mcus_w
    my = mcu_start.to(i64) // geom.mcus_w
    mcu_rem = mcu_count.to(i64)
    zero = torch.zeros(n_lanes, dtype=i64, device=dev)
    acc0, acc1, navail, wcur, slot, k = (zero.clone() for _ in range(6))
    dc = torch.zeros((n_lanes, 3), dtype=i64, device=dev)
    err = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
    out = torch.zeros(out_size, dtype=torch.int16, device=dev)

    for step in range(max_steps):
        active = (mcu_rem > 0) & ~err
        if step % 32 == 0 and not bool(active.any()):
            break
        # refill (words at or past n_words read as zero)
        need = navail <= 32
        w = dense64[(woff + wcur).clamp(0, n_dense - 1)]
        w = torch.where(wcur < n_words, w, zero)
        hi = torch.where(navail < 32, w >> (navail & 31), zero)
        lo = torch.where(navail == 0, zero,
                         torch.where(navail == 32, w,
                                     (w << ((32 - navail) & 31)) & _M32))
        acc0 = torch.where(need, acc0 | hi, acc0)
        acc1 = torch.where(need, acc1 | lo, acc1)
        navail = torch.where(need, navail + 32, navail)
        wcur = torch.where(need, wcur + 1, wcur)

        # code length, code, base
        win = acc0
        is_dc = k == 0
        tslot = torch.where(is_dc, dc_slot[slot], ac_slot[slot]) + 4 * bank
        trow = torch.where((tslot >= 0) & (tslot < nrows), tslot, nrows - 1)
        cand = win[:, None] >> shifts[None, :]
        valid = cand < maxc1_t[trow]
        found = valid.any(1)
        lsel = valid.to(torch.uint8).argmax(1, keepdim=True)
        code = torch.where(found, cand.gather(1, lsel)[:, 0], zero)
        base = torch.where(found, base15_t[trow].gather(1, lsel)[:, 0], zero)
        codelen = torch.where(found, lsel[:, 0] + 1, zero + 1)

        # symbol byte
        sym_idx = (code + base) & 0x7FFF
        tin = tslot - 4 * bank
        toff = torch.where(tin == 0, VAL_OFFS[0], torch.where(
            tin == 1, VAL_OFFS[1], torch.where(tin == 2, VAL_OFFS[2],
                                               VAL_OFFS[3])))
        flat_sym = (toff + sym_idx).clamp(0, VAL_TOTAL - 1)
        widx = (flat_sym >> 2) + VAL_WORDS * bank
        vword = torch.where((widx >= 0) & (widx < vals.numel()),
                            vals[widx.clamp(0, vals.numel() - 1)], zero)
        symbol = (vword >> ((flat_sym & 3) << 3)) & 0xFF
        run = symbol >> 4
        size = symbol & 15

        # extend bits
        ext = (win >> (32 - codelen - size)) & ((1 << size) - 1)
        half = 1 << (size - 1).clamp(min=0)
        val = torch.where(size == 0, zero,
                          torch.where(ext < half, ext - (half << 1) + 1, ext))

        # DC predictor
        comp = comp_of[slot][:, None]
        dc_cur = dc.gather(1, comp)[:, 0]
        dc_new = _wrap(dc_cur + val, 32)
        dc.scatter_(1, comp, torch.where(active & is_dc, dc_new,
                                         dc_cur)[:, None])

        # AC bookkeeping + coefficient writes
        is_eob = ~is_dc & (size == 0) & (run != 15)
        is_zrl = ~is_dc & (size == 0) & (run == 15)
        k_coeff = torch.where(is_dc, zero, (k + run).clamp(max=63))
        overrun = ~is_dc & (size > 0) & (k + run > 63)
        writes = active & (is_dc | ((size > 0) & ~overrun))
        err = err | (active & (~found | overrun))
        block_flat = (base_img + flat_off[slot] + my * row_step[slot]
                      + mx * col_step[slot])
        idx = _wrap(block_flat * 64 + zig[k_coeff], 32)
        ok = writes & (idx >= 0) & (idx < out_size)
        write_val = _wrap(torch.where(is_dc, dc_new, val), 16)
        out[idx[ok]] = write_val[ok].to(torch.int16)

        # advance
        k_next = torch.where(is_dc, zero + 1, torch.where(
            is_eob, zero + 64, torch.where(is_zrl, k + 16, k + run + 1)))
        block_done = k_next >= 64
        slot_next = torch.where(block_done, slot + 1, slot)
        mcu_done = slot_next >= len(geom.flat_off)
        slot_next = torch.where(mcu_done, zero, slot_next)
        k_next = torch.where(block_done, zero, k_next)
        mx_next = torch.where(mcu_done, mx + 1, mx)
        row_wrap = mx_next >= geom.mcus_w
        mx_next = torch.where(row_wrap, zero, mx_next)
        my_next = torch.where(row_wrap, my + 1, my)
        rem_next = torch.where(mcu_done, mcu_rem - 1, mcu_rem)

        # consume codelen + size bits
        n = codelen + size
        acc0_n = ((acc0 << n) & _M32) | ((acc1 >> 1) >> (31 - n))
        acc1_n = (acc1 << n) & _M32
        acc0 = torch.where(active, acc0_n, acc0)
        acc1 = torch.where(active, acc1_n, acc1)
        navail = torch.where(active, navail - n, navail)
        mx = torch.where(active, mx_next, mx)
        my = torch.where(active, my_next, my)
        mcu_rem = torch.where(active, rem_next, mcu_rem)
        slot = torch.where(active, slot_next, slot)
        k = torch.where(active, k_next, k)

    return out, err | (mcu_rem > 0)
