"""Host lane packer for the wave kernel.

Ported from ``rocjpeg_tpu/ops/device_entropy.py`` (the dense
``pack_segments`` and ``pack_virtual_segments``). A *lane* is one
independently decodable piece of a scan: a real restart segment, or a
"virtual" segment that starts at an MCU boundary the native index walk
recorded (bit offset, MCU index, DC predictors) in a DRI=0 scan. All lanes
of a group are shipped as one dense big-endian word stream plus a
per-lane starting word offset; the wave kernel reads its lane's words
straight from that stream.

Differences from the JAX packer, all of them TPU-only layout concerns:
no (R, n_words, 128) lane-major tensor, lanes padded to a multiple of 256
(not a power-of-two bucket or the Pallas tile quantum), the dense stream
sized to exactly its payload plus one lane window of zero tail, and fresh
zeroed buffers instead of pooled dirty ones. The word budget per lane
(``n_words``) is bucketed exactly as in the JAX packer: words past it read
as zero in the kernel, which decides where a corrupt lane errs.

The native host library (``runtime.native``) does the byte work; it is
built at first use, and a build that fails raises.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
from typing import Sequence

import numpy as np
from torch.profiler import record_function

from ..core.bitstream import JpegStreamParams
from ..runtime import native
from ..status import RocJpegError, Status

LANE_QUANTUM = 256


@dataclasses.dataclass
class PackedDense:
    """One decode group's lanes: the dense word stream and per-lane
    geometry. Padding lanes have mcu_count == 0 and decode nothing."""
    dense: np.ndarray      # (W,) uint32, big-endian packed bytes
    word_off: np.ndarray   # (n_lanes,) int32 — lane's first word in dense
    img_base: np.ndarray   # (n_lanes,) int32 — img_idx * total_blocks
    mcu_start: np.ndarray  # (n_lanes,) int32
    mcu_count: np.ndarray  # (n_lanes,) int32
    n_lanes: int
    n_words: int           # word budget per lane; words past it read as 0
    max_seg_bits: int      # real payload bits of the longest lane
    max_lane_syms: int = 0  # exact max symbols in any lane (0 = unknown)
    lane_bank: np.ndarray = None  # (n_lanes,) int32 table bank per lane


def _bucket(n: int, quantum: int) -> int:
    """Round n up to a power-of-two multiple of quantum."""
    b = quantum
    while b < n:
        b <<= 1
    return b


def _bucket_fine(n: int, quantum: int) -> int:
    """Round n up to a 1/8-geometric bucket (a power of two times 8..15
    eighths of a quantum)."""
    b = quantum
    while b * 2 < n:
        b <<= 1
    if n <= b:
        return b
    step = max(b // 8, quantum)
    return b + -(-(n - b) // step) * step


def _pad_lanes(n: int) -> int:
    return -(-max(n, 1) // LANE_QUANTUM) * LANE_QUANTUM


def _map(fn, jobs):
    """Run fn over jobs on a thread pool (the native calls release the
    GIL); one job runs inline."""
    if len(jobs) <= 1:
        return [fn(j) for j in jobs]
    workers = min(len(jobs), os.cpu_count() or 1)
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        return list(pool.map(fn, jobs))


def _total_mcus(p: JpegStreamParams) -> int:
    if len(p.scan_components) > 1:
        return p.num_mcus
    return ((p.picture_width + 7) // 8) * ((p.picture_height + 7) // 8)


def _geometry_rows(params_list):
    """Per-image (needed segment count, restart interval, total MCUs)."""
    rows = []
    for p in params_list:
        total = _total_mcus(p)
        ri = p.restart_interval if p.restart_interval > 0 else total
        rows.append(((total + ri - 1) // ri, ri, total))
    return rows


def _lane_geometry(geo, lane_starts, n_pad, total_blocks, seg0=None,
                   bank_of=None):
    img_base = np.zeros(n_pad, np.int32)
    mcu_start = np.zeros(n_pad, np.int32)
    mcu_count = np.zeros(n_pad, np.int32)
    lane_bank = np.zeros(n_pad, np.int32)
    for i, ((needed, ri, total), l0) in enumerate(zip(geo, lane_starts)):
        sl = slice(l0, l0 + needed)
        img_base[sl] = i * total_blocks
        s0 = seg0[i] if seg0 is not None else 0
        ms = (s0 + np.arange(needed, dtype=np.int32)) * ri
        mcu_start[sl] = ms
        mcu_count[sl] = np.minimum(ri, total - ms)
        if bank_of is not None:
            lane_bank[sl] = bank_of[i]
    return img_base, mcu_start, mcu_count, lane_bank


def pack_segments(params_list: Sequence[JpegStreamParams],
                  total_blocks: int, mcu_range=None,
                  bank_of=None) -> PackedDense:
    """Split each image's scan at RSTn markers, unstuff, and pack every
    segment of the group word-aligned into one dense big-endian stream.

    mcu_range=(lo, hi) packs only the restart segments intersecting that
    MCU index range (the ROI fast path): DC predictors reset at every RSTn,
    so a crop's segments decode without the rest of the scan; blocks
    outside the packed lanes stay zero."""
    geo = _geometry_rows(params_list)
    sel = None
    geo_sel = geo
    if mcu_range is not None:
        lo, hi = mcu_range
        sel = []
        for needed, ri, total in geo:
            s0 = max(0, min(lo // ri, needed))
            s1 = max(s0, min(needed, -(-hi // ri)))
            sel.append((s0, s1))
        geo_sel = [(s1 - s0, ri, total)
                   for (s0, s1), (_n, ri, total) in zip(sel, geo)]
    lane_starts = []
    acc = 0
    for g in geo_sel:
        lane_starts.append(acc)
        acc += g[0]
    n_pad = _pad_lanes(acc)

    # ---- phase 1: clean segment lengths (and raw offsets for the ROI) ----
    raw_starts = [0] * len(params_list)

    def _lens(i):
        p = params_list[i]
        needed = geo[i][0]
        if sel is None:
            lens, found = native.seg_lens(p.slice_data, needed)
        else:
            lens, raw, found = native.seg_offsets(p.slice_data, needed)
        if found < needed:
            raise RocJpegError(Status.BAD_JPEG, "missing restart segments")
        if sel is None:
            return lens[:needed]
        s0, s1 = sel[i]
        raw_starts[i] = int(raw[s0]) if s0 < needed else len(p.slice_data)
        return lens[s0:s1]

    seg_len_rows = _map(_lens, list(range(len(params_list))))
    all_len = np.concatenate(seg_len_rows)
    max_len = int(all_len.max()) if all_len.size else 0
    n_words = (max_len + 3) // 4 + 2  # +2 pad words: the window may run on
    n_words = _bucket(-(-n_words // 8) * 8, 8)

    # ---- phase 2: per-lane word offsets + the dense word stream ----
    lane_words = np.zeros(n_pad, np.int64)
    for lens, l0 in zip(seg_len_rows, lane_starts):
        lane_words[l0:l0 + lens.size] = (lens.astype(np.int64) + 3) // 4
    word_off = np.zeros(n_pad + 1, np.int64)
    np.cumsum(lane_words, out=word_off[1:])
    # Zero tail of one lane window: every lane's window stays in range.
    dense = np.zeros(int(word_off[-1]) + n_words, np.uint32)
    word_off32 = word_off[:n_pad].astype(np.int32)

    def _pack(i):
        needed, l0 = geo_sel[i][0], lane_starts[i]
        data = params_list[i].slice_data
        if raw_starts[i]:
            data = data[raw_starts[i]:]
        native.pack_dense(data, dense, word_off32[l0:l0 + needed], needed)

    _map(_pack, list(range(len(params_list))))

    seg0 = [s[0] for s in sel] if sel is not None else None
    img_base, mcu_start, mcu_count, lane_bank = _lane_geometry(
        geo_sel, lane_starts, n_pad, total_blocks, seg0=seg0,
        bank_of=bank_of)
    return PackedDense(dense=dense, word_off=word_off32, img_base=img_base,
                       mcu_start=mcu_start, mcu_count=mcu_count,
                       n_lanes=n_pad, n_words=n_words,
                       max_seg_bits=max_len * 8, lane_bank=lane_bank)


def _scan_chunk(chunk, min_symbols):
    """Index-walk one chunk of streams with the widest native walker that
    takes it: 32 or 16 streams in AVX-512 lockstep, 8 in AVX2, else pairs
    on the dual-stream scalar walker. Every walker gives the same records."""
    n = len(chunk)
    if n in (32, 16, 8):
        walk = {32: native.index_scan32, 16: native.index_scan16,
                8: native.index_scan8}[n]
        out = walk(chunk, min_symbols)
        if out is not None:
            return out
        if n > 8:
            half = n // 2
            return (_scan_chunk(chunk[:half], min_symbols)
                    + _scan_chunk(chunk[half:], min_symbols))
    out = []
    for i in range(0, n, 2):
        pair = chunk[i:i + 2]
        if len(pair) == 2:
            out.extend(native.index_scan2(pair[0], pair[1], min_symbols))
        else:
            out.append(native.index_scan(pair[0], min_symbols))
    return out


def pack_virtual_segments(params_list: Sequence[JpegStreamParams],
                          total_blocks: int, min_symbols: int,
                          mcu_range=None, bank_of=None):
    """Pack DRI=0 scans for the wave by manufacturing restart points: the
    native index walk records (bit offset, MCU index, DC predictors) at the
    first MCU boundary after every >= ``min_symbols`` symbols; each such
    virtual segment becomes a lane, bit-aligned by the pack.

    Returns (PackedDense, dc_flat int32 (n_lanes, 3),
    lane_of_mcu int32 (B, total_mcus)): dc_flat[l, c] is component c's DC
    predictor entering lane l (the transform adds it to every DC
    coefficient the lane decoded); lane_of_mcu[b, m] is the lane that
    decodes MCU m of image b.

    mcu_range=(lo, hi): pack only the lanes intersecting that MCU range
    (ROI fast path); the walk still covers the whole stream.

    Raises RocJpegError(BAD_JPEG) when a walk hits an invalid code; the
    caller falls back to the host path, which reports precisely."""
    total = _total_mcus(params_list[0])
    S = max(1, min_symbols)
    B = len(params_list)

    # ---- phase 1: index walks ----
    avx512 = native.index_scan16_available()
    cw = 32 if avx512 and B >= 32 else (16 if avx512 and B >= 16 else 8)
    chunks = [params_list[i:i + cw] for i in range(0, B, cw)]
    with record_function("rjt.walk"):
        scans = [r for rs in _map(lambda c: _scan_chunk(c, S), chunks)
                 for r in rs]

    # (clean, bo, dc, mi, sc, end_bit, end_mcu): the end markers bound the
    # last lane (next record's position, or the stream / image end).
    scans = [(clean, bo, dc, mi, sc, len(clean) * 8, total)
             for clean, bo, dc, mi, sc in scans]
    if mcu_range is not None:
        lo, hi = mcu_range
        filtered = []
        for clean, bo, dc, mi, sc, eb, em in scans:
            i0 = max(0, int(np.searchsorted(mi, lo, side="right")) - 1)
            i1 = max(i0, int(np.searchsorted(mi, hi, side="left")))
            if i1 < len(bo):
                eb, em = int(bo[i1]), int(mi[i1])
            filtered.append((clean, bo[i0:i1], dc[i0:i1], mi[i0:i1],
                             sc[i0:i1], eb, em))
        scans = filtered

    lane_starts = []
    acc = 0
    meta = []
    for i, (clean, bo, dc, mi, sc, eb, em) in enumerate(scans):
        lane_starts.append(acc)
        meta.append((bo, dc, mi, sc, eb, em, acc, i * total_blocks,
                     int(bank_of[i]) if bank_of is not None else 0, i))
        acc += len(bo)

    geom_jobs = native.build_geom_jobs(meta)
    max_bits, max_syms = native.record_maxes(geom_jobs, len(meta))
    n_words = (max_bits + 31) // 32 + 2
    n_words = (_bucket_fine(n_words, 64) if n_words > 8
               else _bucket(-(-n_words // 8) * 8, 8))
    n_pad = _pad_lanes(acc)

    # ---- per-lane geometry + dense word offsets ----
    lane_words = np.zeros(n_pad, np.int64)
    bit_starts = np.zeros(n_pad, np.int64)
    bit_ends = np.zeros(n_pad, np.int64)
    img_base = np.zeros(n_pad, np.int32)
    mcu_start = np.zeros(n_pad, np.int32)
    mcu_count = np.zeros(n_pad, np.int32)
    lane_bank = np.zeros(n_pad, np.int32)
    dc_flat = np.zeros((n_pad, 3), np.int32)
    lane_of_mcu = np.zeros((B, total), np.int32)
    native.lane_geometry(geom_jobs, len(meta), lane_words, bit_starts,
                         bit_ends, img_base, mcu_start, mcu_count,
                         lane_bank, dc_flat, lane_of_mcu, total)

    word_off = np.zeros(n_pad + 1, np.int64)
    np.cumsum(lane_words, out=word_off[1:])
    dense = np.zeros(int(word_off[-1]) + n_words, np.uint32)
    word_off32 = word_off[:n_pad].astype(np.int32)

    # ---- phase 2: bit-aligned lane copies into the dense stream ----
    dense_u8 = dense.view(np.uint8)
    for i, (clean, bo, dc, mi, sc, eb, em) in enumerate(scans):
        sl = slice(lane_starts[i], lane_starts[i] + len(bo))
        native.pack_bits(clean, dense_u8, word_off32[sl], bit_starts[sl],
                         bit_ends[sl])

    packed = PackedDense(dense=dense, word_off=word_off32, img_base=img_base,
                         mcu_start=mcu_start, mcu_count=mcu_count,
                         n_lanes=n_pad, n_words=n_words,
                         max_seg_bits=max_bits,
                         max_lane_syms=max_syms, lane_bank=lane_bank)
    return packed, dc_flat, lane_of_mcu
