"""Host lane packer for the wave kernel.

Ported from ``rocjpeg_tpu/ops/device_entropy.py`` (the dense
``pack_segments`` and ``pack_virtual_segments``). A *lane* is one
independently decodable piece of a scan: a real restart segment, or a
"virtual" segment that starts at an MCU boundary the native index walk
recorded (bit offset, MCU index, DC predictors) in a DRI=0 scan. All lanes
of a group are shipped as one dense big-endian word stream plus a
per-lane starting word offset; the wave kernel reads its lane's words
straight from that stream.

Layout differences from the JAX packer: no (R, n_words, 128) lane-major
tensor, lanes padded to a multiple of 256 (not a power-of-two bucket or
the Pallas tile quantum), and the dense stream sized to exactly its payload
plus one lane window of zero tail (K1 clamps its word reads to the stream's
last word, so the device view keeps exactly this length). The word budget
per lane (``n_words``) is bucketed exactly as in the JAX packer: words past
it read as zero in the kernel, which decides where a corrupt lane errs.

Every array the device reads is written into the group's staging buffer
(``ops.staging.Stager``): ``word_off``, ``img_base``, ``mcu_start``,
``mcu_count``, ``lane_bank``, ``dense`` and, for virtual lanes, ``dc_flat``
and ``lane_of_mcu``. The buffers are pooled and dirty, so the packers zero
every byte a fresh ``np.zeros`` used to guarantee: the padding lanes of the
five lane arrays (``mcu_count == 0`` is what stops K1 decoding them), the
``n_words`` tail of ``dense``, the last word of each restart segment
(``rjt_pack_dense`` writes a segment's bytes, not whole words, and the bits
after a lane's end decide where a corrupt lane errs), and ``lane_of_mcu``
on the ROI path or wherever the walk's records do not start at MCU 0.
``rjt_pack_bits`` writes whole words, and the walk's records cover every
MCU of the full-image path, so nothing else needs zeroing. Called without
a stager, a packer stages into a private buffer of its own.

The native host library (``runtime.native``) does the byte work; it is
built at first use, and a build that fails raises.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import threading
from typing import Sequence

import numpy as np

from ..core.bitstream import JpegStreamParams
from ..runtime import native
from ..status import RocJpegError, Status
from ..utils.trace import span
from . import staging
from .staging import bucket as _bucket, bucket_fine as _bucket_fine

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


def _pad_lanes(n: int) -> int:
    return -(-max(n, 1) // LANE_QUANTUM) * LANE_QUANTUM


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


def _lane_geometry(geo, lane_starts, n_real, total_blocks, views,
                   seg0=None, bank_of=None):
    """Restart lanes' geometry into the staged (dirty) lane arrays: every
    real lane written, every padding lane zeroed."""
    img_base, mcu_start, mcu_count, lane_bank = (
        views[k] for k in ("img_base", "mcu_start", "mcu_count", "lane_bank"))
    for a in (img_base, mcu_start, mcu_count, lane_bank):
        a[n_real:] = 0
    for i, ((needed, ri, total), l0) in enumerate(zip(geo, lane_starts)):
        sl = slice(l0, l0 + needed)
        img_base[sl] = i * total_blocks
        s0 = seg0[i] if seg0 is not None else 0
        ms = (s0 + np.arange(needed, dtype=np.int32)) * ri
        mcu_start[sl] = ms
        mcu_count[sl] = np.minimum(ri, total - ms)
        lane_bank[sl] = bank_of[i] if bank_of is not None else 0


_LANE_ARRAYS = ("word_off", "img_base", "mcu_start", "mcu_count", "lane_bank")


def _packed(st, n_pad, n_words, max_seg_bits, max_lane_syms=0):
    v = {k: st.view(k) for k in _LANE_ARRAYS + ("dense",)}
    return PackedDense(n_lanes=n_pad, n_words=n_words,
                       max_seg_bits=max_seg_bits,
                       max_lane_syms=max_lane_syms, **v)


def pack_segments(params_list: Sequence[JpegStreamParams],
                  total_blocks: int, mcu_range=None,
                  bank_of=None, stager=None) -> PackedDense:
    """Split each image's scan at RSTn markers, unstuff, and pack every
    segment of the group word-aligned into one dense big-endian stream.

    mcu_range=(lo, hi) packs only the restart segments intersecting that
    MCU index range (the ROI fast path): DC predictors reset at every RSTn,
    so a crop's segments decode without the rest of the scan; blocks
    outside the packed lanes stay zero.

    ``stager`` (an unopened ``staging.Stager``) receives the arrays and is
    opened here; the returned arrays are views of its buffer. Without one
    the arrays live in a buffer of their own."""
    st = stager if stager is not None else staging.Stager()
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

    seg_len_rows = staging.map_jobs(_lens, list(range(len(params_list))))
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
    used = int(word_off[-1])
    for name in _LANE_ARRAYS:
        st.reserve(name, (n_pad,), np.int32)
    # Zero tail of one lane window: every lane's window stays in range.
    st.reserve("dense", (used + n_words,), np.uint32)
    st.open()
    dense = st.view("dense")
    dense[used:] = 0
    # A segment's last word may be partial: zero it before the bytes land.
    dense[word_off[1:][lane_words > 0] - 1] = 0
    word_off32 = st.view("word_off")
    word_off32[:] = word_off[:n_pad]

    def _pack(i):
        needed, l0 = geo_sel[i][0], lane_starts[i]
        data = params_list[i].slice_data
        if raw_starts[i]:
            data = data[raw_starts[i]:]
        native.pack_dense(data, dense, word_off32[l0:l0 + needed], needed)

    staging.map_jobs(_pack, list(range(len(params_list))))

    seg0 = [s[0] for s in sel] if sel is not None else None
    _lane_geometry(geo_sel, lane_starts, acc, total_blocks,
                   {k: st.view(k) for k in _LANE_ARRAYS}, seg0=seg0,
                   bank_of=bank_of)
    return _packed(st, n_pad, n_words, max_len * 8)


# Process-wide counts of the index walk, reset by :func:`reset_walk_counts`:
# the chunks each native walker walked ("index_scan2" a pair, "index_scan"
# a single stream), "narrowed" the chunks a SIMD walker handed back,
# "span_narrowed" the chunks :func:`index_walk` made narrower than the
# width rule because their slab would pass the AVX-512 walkers' reach, and
# "device" the chunks whose lanes K0 found on the card (no host walk).
WALK_COUNTS = ("index_scan32", "index_scan16", "index_scan8", "index_scan2",
               "index_scan", "narrowed", "span_narrowed", "device")
_walk_counts = dict.fromkeys(WALK_COUNTS, 0)
_walk_counts_lock = threading.Lock()


def walk_counts() -> dict:
    """The index walk's counts since the last reset (``WALK_COUNTS``)."""
    with _walk_counts_lock:
        return dict(_walk_counts)


def reset_walk_counts() -> None:
    with _walk_counts_lock:
        _walk_counts.update(dict.fromkeys(WALK_COUNTS, 0))


def _count(name: str, n: int = 1) -> None:
    with _walk_counts_lock:
        _walk_counts[name] += n


def count_device_walk() -> None:
    """Count a chunk whose lanes K0 found on the card."""
    _count("device")


def _scan_chunk(chunk, min_symbols, bufs):
    """Index-walk one chunk of streams with the widest native walker that
    takes it: 32 or 16 streams in AVX-512 lockstep, 8 in AVX2, else pairs
    on the dual-stream scalar walker. Every walker gives the same records.
    A SIMD walker hands a chunk back (``None``) when the host lacks its
    tier, when the jobs are not uniform (two table sets in one chunk, as
    in the bench's mixed leg), when a stream does not unstuff, or, for the
    AVX-512 walkers, when the clean streams lie beyond 32-bit offsets of
    the first (the pool's slab rules that out); the chunk is then walked
    as two halves, as the JAX package does, and counted ``narrowed``.
    ``bufs``: one pooled buffer set a stream."""
    n = len(chunk)
    if n in (32, 16, 8):
        name = f"index_scan{n}"
        out = getattr(native, name)(chunk, min_symbols, bufs)
        if out is not None:
            _count(name)
            return out
        _count("narrowed")
        if n > 8:
            half = n // 2
            return (_scan_chunk(chunk[:half], min_symbols, bufs[:half])
                    + _scan_chunk(chunk[half:], min_symbols, bufs[half:]))
    out = []
    for i in range(0, n, 2):
        pair = chunk[i:i + 2]
        if len(pair) == 2:
            out.extend(native.index_scan2(pair[0], pair[1], min_symbols,
                                          bufs[i:i + 2]))
            _count("index_scan2")
        else:
            out.append(native.index_scan(pair[0], min_symbols, bufs[i]))
            _count("index_scan")
    return out


def _words_bound(scans) -> int:
    """An upper bound on the dense words of ``scans``' lanes, before the
    native geometry pass computes them: each lane's ceil(bits / 32), with
    the native pass's zero for an empty or backward span."""
    total = 0
    for _clean, bo, _dc, _mi, _sc, eb, _em in scans:
        if len(bo):
            span = np.diff(np.append(bo, eb))
            total += int(np.maximum((span + 31) // 32, 0).sum())
    return total


def index_walk(params_list: Sequence[JpegStreamParams], min_symbols: int):
    """Phase 1 of :func:`pack_virtual_segments`: the native index walk of
    every stream, in chunks of the widest walker the host and the batch
    allow (32 or 16 streams with AVX-512, else 8), the chunks side by side
    on :func:`staging.pack_pool`, each on a buffer set of
    ``staging.walk_buffer_pool()``. A width whose slab would not fit the
    AVX-512 walkers' 32-bit offsets (``staging.slab_fits``) is halved
    first, down to 8, and its chunks are counted ``span_narrowed``.

    Returns (scans, tokens): one (clean, bit_off, dc, mcu_idx, sym_count)
    a stream, views of the pooled sets, and the sets' tokens, which go back
    to the pool (``release``) once nothing refers to the scans."""
    S = max(1, min_symbols)
    B = len(params_list)
    caps = [native.index_job_capacities(p, S) for p in params_list]
    avx512 = native.index_scan16_available()
    widest = cw = 32 if avx512 and B >= 32 else (16 if avx512 and B >= 16
                                                 else 8)
    while cw > 8 and not staging.slab_fits(
            cw, max((c[0] for c in caps), default=0)):
        cw //= 2
    starts = range(0, B, cw)
    if cw < widest:
        _count("span_narrowed", len(starts))
    pool = staging.walk_buffer_pool()
    tokens, tokens_lock = [], threading.Lock()

    def _walk(i):
        chunk, ccaps = params_list[i:i + cw], caps[i:i + cw]
        token, bufs = pool.acquire(len(chunk), max(c[0] for c in ccaps),
                                   max(c[1] for c in ccaps))
        with tokens_lock:
            tokens.append(token)
        return _scan_chunk(chunk, S, bufs)

    with span("rjt.walk"):
        scans = [r for rs in staging.map_jobs(_walk, starts) for r in rs]
    return scans, tokens


def pack_virtual_segments(params_list: Sequence[JpegStreamParams],
                          total_blocks: int, min_symbols: int,
                          mcu_range=None, bank_of=None, stager=None):
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

    ``stager``: as for :func:`pack_segments`, with ``dc_flat`` and
    ``lane_of_mcu`` staged too. The walk's buffer sets come from the
    process's ``staging.walk_buffer_pool()`` and go back to it once the
    lanes are packed (after an exception they are dropped).

    Raises RocJpegError(BAD_JPEG) when a walk hits an invalid code; the
    caller falls back to the host path, which reports precisely."""
    st = stager if stager is not None else staging.Stager()
    total = _total_mcus(params_list[0])
    B = len(params_list)
    pool = staging.walk_buffer_pool()

    # ---- phase 1: index walks, one pooled buffer set a chunk ----
    scans, tokens = index_walk(params_list, min_symbols)

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

    # ---- per-lane geometry (staged) + dense word offsets ----
    for name in _LANE_ARRAYS:
        st.reserve(name, (n_pad,), np.int32)
    st.reserve("dc_flat", (n_pad, 3), np.int32)
    st.reserve("lane_of_mcu", (B, total), np.int32)
    st.open(spare=4 * (_words_bound(scans) + n_words))
    v = {k: st.view(k) for k in _LANE_ARRAYS + ("dc_flat", "lane_of_mcu")}
    for k in ("img_base", "mcu_start", "mcu_count", "lane_bank", "dc_flat"):
        v[k][acc:] = 0
    # The native pass writes the MCUs of each record's lane: from the first
    # record to the image end, so every MCU when the records start at 0.
    if mcu_range is not None or any(len(s[3]) == 0 or s[3][0] != 0
                                    for s in scans):
        v["lane_of_mcu"][:] = 0
    lane_words = np.zeros(n_pad, np.int64)
    bit_starts = np.zeros(n_pad, np.int64)
    bit_ends = np.zeros(n_pad, np.int64)
    native.lane_geometry(geom_jobs, len(meta), lane_words, bit_starts,
                         bit_ends, v["img_base"], v["mcu_start"],
                         v["mcu_count"], v["lane_bank"], v["dc_flat"],
                         v["lane_of_mcu"], total)

    word_off = np.zeros(n_pad + 1, np.int64)
    np.cumsum(lane_words, out=word_off[1:])
    used = int(word_off[-1])
    word_off32 = v["word_off"]
    word_off32[:] = word_off[:n_pad]
    dense = st.reserve("dense", (used + n_words,), np.uint32)
    dense[used:] = 0

    # ---- phase 2: bit-aligned lane copies into the dense stream (whole
    # words: every word of [0, used) is written) ----
    dense_u8 = dense.view(np.uint8)
    for i, (clean, bo, dc, mi, sc, eb, em) in enumerate(scans):
        sl = slice(lane_starts[i], lane_starts[i] + len(bo))
        native.pack_bits(clean, dense_u8, word_off32[sl], bit_starts[sl],
                         bit_ends[sl])
    # Nothing that escapes refers to the walk's buffers any more.
    for token in tokens:
        pool.release(token)

    packed = _packed(st, n_pad, n_words, max_bits, max_syms)
    return packed, v["dc_flat"], v["lane_of_mcu"]


# --- DRI=0 groups on a CUDA device: the host half of K0 --------------------
#
# On a card no walk runs on the host. Each stream is unstuffed straight
# into the group's staging buffer, one word-aligned region an image, and
# K0 (``kernels.sync``, ``csrc/sync.cu``) finds the lanes on the card: one
# a subsequence of ``subseq_bits`` bits of a clean stream, starting at the
# first MCU boundary at or after the subsequence's start.

# Bits of clean stream a K0 subsequence covers: one lane each. Chosen on the
# H100 by the device time of K0 plus K1 at both main-path groups
# (``chip_smoke.py``'s ``[sync]`` phase).
SUBSEQ_BITS = 2048
# Zero bits a stream's last lane carries past the clean stream (the host
# walk reads zeros there, up to 56 bits past the end, plus a symbol).
LANE_TAIL_BITS = 128
# Columns of K0's per-image table (csrc/sync.cu I_*): the clean region's
# first word, the clean bytes, the table bank, the first subsequence, the
# subsequences, the image's first dense word and its dense words.
SYNC_IMG_COLS = 8
# A group's streams are unstuffed on the pack pool from this many bytes on,
# else in the calling thread, which keeps the interpreter lock: for 16 4K
# frames (26 MB) that cost three client threads a quarter of their
# throughput on an 8-core H100 host, while a 32-image chunk (2.6 MB) loses
# more to the pool's hand-offs than it gains.
_POOL_UNSTUFF_BYTES = 8 << 20
# Bits of the longest legal MCU block: a 16-bit DC code and 11 bits, then
# 63 AC symbols of a 16-bit code and 10 bits (T.81 F.1.2).
_BLOCK_BITS = 16 + 11 + 63 * (16 + 10)


@dataclasses.dataclass
class SyncPlan:
    """One DRI=0 group staged for K0: the per-image table (a view of the
    staging buffer, ``SYNC_IMG_COLS`` int32 columns) and the sizes the
    device half allocates. ``n_words`` and ``max_steps`` are K1's static
    bounds for lanes of ``subseq_bits``."""
    img: np.ndarray
    subseq_bits: int
    period: int       # slot_period of the group
    n_sub: int        # subsequences (lanes before padding)
    n_pad: int        # lanes, padded to LANE_QUANTUM
    n_dense: int      # words of the dense stream, its zero tail included
    n_words: int
    max_steps: int
    lane_img: np.ndarray  # (n_pad,) int32: lane -> image within the group


def sync_bounds(nslots: int, subseq_bits: int) -> tuple:
    """K1's (n_words, max_steps) for K0's lanes: a lane runs from its
    subsequence's first MCU boundary to the first one at or after the next
    subsequence's start, so it holds at most ``subseq_bits`` + a symbol +
    one MCU of bits (the last lane: ``LANE_TAIL_BITS`` past its
    subsequence), and every symbol takes a bit."""
    bits = subseq_bits + LANE_TAIL_BITS + nslots * _BLOCK_BITS
    n_words = -(-(-(-bits // 32) + 2) // 8) * 8
    return n_words, -(-bits // 256) * 256


def _walk_refuses(p: JpegStreamParams) -> bool:
    """Whether the host index walk would refuse ``p``'s tables (its
    ``build_idx_tabs``): a selector past the four tables or of a table not
    loaded, an overlong code, or a DC size past 11 or an AC size past 10.
    K0 decodes with K1's tables and takes the walk's refusals from here, so
    such a stream still falls back to the host path."""
    used = []
    for sc in p.scan_components:
        for tid, dc in ((sc.dc_table_selector, True),
                        (sc.ac_table_selector, False)):
            if not (0 <= tid < min(4, len(p.huffman_tables))
                    and p.load_huffman_table[tid]):
                return True
            t = p.huffman_tables[tid]
            bits, values = ((t.num_dc_codes, t.dc_values) if dc
                            else (t.num_ac_codes, t.ac_values))
            used.append((bytes(np.asarray(bits, np.uint8)),
                         bytes(np.asarray(values, np.uint8)), dc))
    return any(_table_refused(*u) for u in used)


@functools.lru_cache(maxsize=256)
def _table_refused(bits: bytes, values: bytes, dc: bool) -> bool:
    code = k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            if code >= 1 << length or k >= len(values):
                return True
            if (values[k] & 15) > (11 if dc else 10):
                return True
            code += 1
            k += 1
        code <<= 1
    return False


def slot_period(params_list: Sequence[JpegStreamParams]) -> int:
    """The fewest block slots after which the (DC table, AC table) of every
    stream's slots, by their bytes and in scan order, repeat: a divisor of
    the MCU's blocks. K0's guessed decodes find the true bit boundaries
    within a few symbols, but the block of the MCU they are in only where a
    table changes; K0 seeks its fixed point on the slot modulo this period
    and then counts blocks for the true slot (``csrc/sync.cu``). Where all
    slots share their tables (as an encoder may write them) it is 1."""
    return math.lcm(*(_period(_slot_key(p)) for p in params_list))


def _slot_key(p: JpegStreamParams) -> tuple:
    """What the period depends on: each scan component's table selectors
    and blocks an MCU, and the bytes of the four tables."""
    scs = p.scan_components
    blocks = (tuple(c.h_sampling_factor * c.v_sampling_factor
                    for c in p.components[:len(scs)])
              if len(scs) > 1 else (1,))
    tables = tuple(
        b"".join(bytes(np.asarray(a, np.uint8)) for a in (
            t.num_dc_codes, t.dc_values, t.num_ac_codes, t.ac_values))
        if t is not None and p.load_huffman_table[tid] else None
        for tid, t in enumerate(p.huffman_tables[:4]))
    return (tuple((sc.dc_table_selector, sc.ac_table_selector)
                  for sc in scs), blocks, tables)


@functools.lru_cache(maxsize=256)
def _period(key: tuple) -> int:
    selectors, blocks, tables = key
    n = sum(blocks)
    if any(not 0 <= tid < 2 for pair in selectors for tid in pair):
        return n  # a table K1 does not bank: no slot shares it

    def table(tid, dc):  # one table's bits and values, or None
        t = tables[tid] if tid < len(tables) else None
        if t is None:
            return None
        n_dc = 16 + sum(t[:16])
        return t[:n_dc] if dc else t[n_dc:]

    pairs = [(table(d, True), table(a, False)) for d, a in selectors]
    slots = [pairs.index(pair) for pair, nb in zip(pairs, blocks)
             for _ in range(nb)]
    return next(q for q in range(1, n + 1) if n % q == 0
                and all(slots[s] == slots[s % q] for s in range(n)))


def stage_clean_streams(params_list: Sequence[JpegStreamParams],
                        nslots: int, bank_of, stager) -> SyncPlan:
    """The host half of a DRI=0 group on a card (``nslots`` blocks an MCU,
    ``bank_of`` each image's table bank): reserve ``sync_img`` and
    ``clean`` in ``stager`` (unopened; this opens it), unstuff every stream
    into its region of ``clean`` (each region word-aligned, 8 zero bytes
    past the clean bytes; on the pack pool where the streams are large)
    and fill the per-image table. The lane count is known here: a stream of ``n``
    clean bits has ceil(n / ``SUBSEQ_BITS``) lanes (at least one).

    Raises RocJpegError(BAD_JPEG) for a stream that does not unstuff (an
    embedded restart marker) or whose tables the host walk refuses; the
    session API then takes the host path, as for a walk's refusal."""
    B = len(params_list)
    subseq_bits = SUBSEQ_BITS
    seen = set()
    for p, bank in zip(params_list, bank_of):
        if bank not in seen:
            seen.add(bank)
            if _walk_refuses(p):
                raise RocJpegError(Status.BAD_JPEG,
                                   "Huffman table the DRI=0 walk refuses")
    region = [-(-(len(p.slice_data) + staging.WALK_SLACK) // 4)
              for p in params_list]
    first = np.zeros(B + 1, np.int64)
    np.cumsum(region, out=first[1:])
    stager.reserve("sync_img", (B, SYNC_IMG_COLS), np.int32)
    stager.reserve("clean", (max(int(first[-1]), 1),), np.uint32)
    stager.open()
    img = stager.view("sync_img")
    clean = stager.view("clean").view(np.uint8)

    def _unstuff(i):
        scan = params_list[i].slice_data
        lo = int(first[i]) * 4
        return native.unstuff_into(scan, clean[lo:lo + len(scan)
                                                + staging.WALK_SLACK])

    # At some 10 GB/s a core, small streams unstuff in one native call in
    # less time than the pack pool takes to hand a job out and back.
    if 4 * int(first[-1]) >= _POOL_UNSTUFF_BYTES:
        nbytes = np.asarray(staging.map_jobs(_unstuff, range(B)), np.int64)
    else:
        nbytes = native.unstuff_many([p.slice_data for p in params_list],
                                     clean, first[:B] * 4)
    nbits = nbytes * 8
    n_sub = np.maximum(-(-nbits // subseq_bits), 1)
    cap = -(-(nbits + LANE_TAIL_BITS) // 32) + n_sub
    sub0 = np.concatenate([[0], np.cumsum(n_sub)[:-1]])
    dense0 = np.concatenate([[0], np.cumsum(cap)[:-1]])
    img[:] = np.stack([first[:B], nbytes, np.asarray(bank_of, np.int64),
                       sub0, n_sub, dense0, cap, np.zeros(B, np.int64)],
                      axis=1)
    total_sub = int(n_sub.sum())
    n_pad = _pad_lanes(total_sub)
    n_words, max_steps = sync_bounds(nslots, subseq_bits)
    lane_img = np.zeros(n_pad, np.int32)
    lane_img[:total_sub] = np.repeat(np.arange(B, dtype=np.int32), n_sub)
    return SyncPlan(img=img, subseq_bits=subseq_bits,
                    period=slot_period(params_list), n_sub=total_sub,
                    n_pad=n_pad, n_dense=int(cap.sum()) + n_words,
                    n_words=n_words, max_steps=max_steps, lane_img=lane_img)
