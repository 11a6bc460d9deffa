"""K0 — the DRI=0 sync: wrapper, plain PyTorch version, launch count.

K0 finds on the card the virtual lanes K1 decodes in a DRI=0 group, the
lane table that ``ops.pack.pack_virtual_segments`` computes on the host
from the native index walk. The host stages each image's unstuffed scan
word-aligned (``ops.pack.stage_clean_streams``); every image's clean stream
is cut into subsequences of ``subseq_bits`` bits, and subsequence ``t``
becomes lane ``t``, starting at the first MCU boundary at or after the
subsequence's start. A lane with no boundary of its own (an MCU longer
than a subsequence, or past the last MCU) has ``mcu_count`` 0, which K1
skips. The CUDA kernels are ``csrc/sync.cu`` (the self-synchronising
decode, on the block slot modulo the slots' table period, and where that
period is shorter than the MCU the true slots and one more decode; the
per-image scans, the realigning copy and the fill of ``lane_of_mcu``);
they replace no TPU kernel but the host walk ``rjt_index_scan*``.

Outputs, for ``n_pad`` lanes (padding lanes all zero):

- ``word_off``, ``img_base``, ``mcu_start``, ``mcu_count``, ``lane_bank``
  (int32) and ``dense`` (int32 words, big-endian bits: each lane's bits
  word-aligned, every word past a lane's end up to the next lane's start,
  each image's unused words and the ``n_words`` tail zero), as K1 reads
  them;
- ``dc_flat`` (n_pad, 3) int32: the DC predictors entering each lane with
  MCUs (0 for the others), which K2 adds; ``lane_of_mcu`` (B, total MCUs)
  int32: for each MCU the last lane of its image that starts at or before
  it;
- ``lane_err`` bool: every lane of an image whose scan has an invalid code
  or ends before its last MCU, by the host walk's rule (an MCU ending more
  than 56 bits past the clean stream); ``rejected`` (1,) int32: 1 where
  any image's is, else 0 (one read tells the session API). Such an image's lanes get
  ``mcu_start``, ``mcu_count``, ``dc_flat`` 0 and ``word_off`` its first
  dense word. With ``mcu_range`` = (lo, hi), lanes whose MCUs miss
  [lo, hi) get ``mcu_count`` 0.

On CPU tensors :func:`sync_lanes` runs :func:`sync_lanes_reference`, a
sequential walk of each stream; on CUDA tensors it launches the kernels or
raises. The sync rounds are counted on the card, in a per-device counter
that only measurement code reads (:func:`max_rounds`): the call never
waits on it.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ..ops.pack import LANE_TAIL_BITS, SYNC_IMG_COLS
from ..ops.tables import MAX_BANKS, VAL_WORDS
from ..status import RocJpegError, Status
from . import build
from .wave import _MAX_SLOTS

launches = 0  # chunks synced on a card; chip_smoke.py resets and reads it

# The host walk's slack: an MCU may end this many bits past the clean stream.
_LIMIT_BITS = 56
(I_CLEAN, I_BYTES, I_BANK, I_SUB, I_NSUB, I_DENSE, I_CAP) = range(7)

_rounds = {}
_rounds_lock = threading.Lock()


@dataclasses.dataclass
class SyncedLanes:
    """K0's lane table for K1 and K2 (see the module docstring)."""
    dense: torch.Tensor
    word_off: torch.Tensor
    img_base: torch.Tensor
    mcu_start: torch.Tensor
    mcu_count: torch.Tensor
    lane_bank: torch.Tensor
    dc_flat: torch.Tensor
    lane_of_mcu: torch.Tensor
    lane_err: torch.Tensor
    rejected: torch.Tensor


def _rounds_counter(device) -> torch.Tensor:
    """The card's (most global sync rounds, most block passes) of any
    group synced on it, as an int32 device tensor."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _rounds_lock:
        t = _rounds.get(device)
        if t is None:
            t = _rounds[device] = torch.zeros(2, dtype=torch.int32,
                                              device=device)
        return t


def max_rounds(device) -> tuple:
    """(global rounds, passes within a block) of the group that took the
    most on ``device`` since the last :func:`reset_rounds` (a device read:
    for measurement code only)."""
    return tuple(int(v) for v in _rounds_counter(device).cpu())


def reset_rounds(device) -> None:
    _rounds_counter(device).zero_()


def _check_inputs(clean, img, lentab, values, geom, subseq_bits):
    for name, t in (("clean", clean), ("img", img), ("lentab", lentab),
                    ("values", values)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise RocJpegError(Status.INVALID_PARAMETER,
                               f"{name} must be a contiguous int32 tensor")
        if t.device != clean.device:
            raise RocJpegError(Status.INVALID_PARAMETER,
                               f"{name} is on {t.device}, not {clean.device}")
    n_banks = lentab.shape[0] // 4
    if (lentab.shape != (4 * n_banks, 16) or not 1 <= n_banks <= MAX_BANKS
            or values.shape != (n_banks * VAL_WORDS,)):
        raise RocJpegError(Status.INVALID_PARAMETER,
                           "lentab/values do not describe 1..4 table banks")
    if img.dim() != 2 or img.shape[1] != SYNC_IMG_COLS or img.shape[0] < 1:
        raise RocJpegError(Status.INVALID_PARAMETER,
                           f"img must be (B, {SYNC_IMG_COLS})")
    if not 1 <= len(geom.flat_off) <= _MAX_SLOTS or geom.ncomp > 3:
        raise RocJpegError(Status.JPEG_NOT_SUPPORTED,
                           "MCU layout beyond 10 blocks or 3 components")
    if subseq_bits < 32:
        raise RocJpegError(Status.INVALID_PARAMETER,
                           "subsequences of fewer than 32 bits")
    return n_banks


def sync_lanes(clean, img, lentab, values, geom, total_mcus: int,
               n_sub: int, n_pad: int, n_dense: int, subseq_bits: int,
               mcu_range=None, period=None) -> SyncedLanes:
    """The lanes of one DRI=0 group (``ops.pack.SyncPlan`` gives the
    sizes).

    clean: int32 words of the staged clean streams (bytes in stream
    order); img: (B, SYNC_IMG_COLS) int32 per-image table; lentab (4 *
    n_banks, 16) and values (n_banks * 89,) int32: K1's tables; geom:
    ops.tables.GroupGeometry; total_mcus: MCUs of an image; n_sub lanes
    of subsequences, padded to n_pad; n_dense: words of ``dense``;
    mcu_range: (lo, hi) of a crop's MCUs, or None; period: the slots'
    table period (``ops.pack.slot_period``), None for the MCU's blocks,
    which is always right and slowest where the tables repeat."""
    global launches
    n_banks = _check_inputs(clean, img, lentab, values, geom, subseq_bits)
    nslots = len(geom.flat_off)
    period = nslots if period is None else period
    if not 1 <= period <= nslots or nslots % period:
        raise RocJpegError(Status.INVALID_PARAMETER,
                           f"slot period {period} of {nslots} slots")
    B = img.shape[0]
    lo, hi = mcu_range if mcu_range is not None else (0, total_mcus)
    if clean.device.type == "cpu":
        return sync_lanes_reference(clean, img, lentab, values, geom,
                                    total_mcus, n_sub, n_pad, n_dense,
                                    subseq_bits, mcu_range)
    if clean.device.type != "cuda":
        raise RocJpegError(Status.INVALID_PARAMETER,
                           f"unsupported device {clean.device}")
    lib = build.library()
    dev = clean.device
    # The int32 outputs are views of one allocation, split in one call:
    # each torch call lets the interpreter lock go, and under busy client
    # threads taking it back can cost milliseconds.
    shapes = {"dense": (n_dense,), "lane_of_mcu": (B, total_mcus),
              "dc_flat": (n_pad, 3), "rejected": (1,), **dict.fromkeys(
                  ("word_off", "img_base", "mcu_start", "mcu_count",
                   "lane_bank"), (n_pad,))}
    sizes = [int(np.prod(shape)) for shape in shapes.values()]
    parts = torch.empty(sum(sizes), dtype=torch.int32, device=dev).split(
        sizes)
    views = {name: part.view(shape) if len(shape) > 1 else part
             for (name, shape), part in zip(shapes.items(), parts)}
    views["lane_err"] = torch.empty(n_pad, dtype=torch.bool, device=dev)
    scratch = torch.empty(int(lib.rjt_sync_scratch_bytes(n_sub, B)),
                          dtype=torch.uint8, device=dev)
    out = SyncedLanes(**views)
    geom_tab = np.ascontiguousarray(
        [geom.dc_slot, geom.ac_slot, geom.comp_of_slot], dtype=np.int32)
    with torch.cuda.device(dev):
        rc = lib.rjt_sync_lanes(
            clean.data_ptr(), clean.numel(), img.data_ptr(), B, n_sub,
            n_pad, lentab.data_ptr(), values.data_ptr(), n_banks,
            geom_tab.ctypes.data, nslots, period, subseq_bits,
            total_mcus, geom.total_blocks, lo, hi, scratch.data_ptr(),
            out.word_off.data_ptr(), out.img_base.data_ptr(),
            out.mcu_start.data_ptr(), out.mcu_count.data_ptr(),
            out.lane_bank.data_ptr(), out.dc_flat.data_ptr(),
            out.lane_err.data_ptr(), out.rejected.data_ptr(),
            out.lane_of_mcu.data_ptr(),
            out.dense.data_ptr(), n_dense,
            _rounds_counter(dev).data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "rjt_sync_lanes")
    with build.count_lock:
        launches += 1
    return out


# --- the plain version --------------------------------------------------------

_VAL_OFF = {0: 0, 1: 16, 2: 32}


def _symbol_table(lentab: np.ndarray, values: np.ndarray, n_banks: int,
                  bank: int, tin: int) -> np.ndarray:
    """K1's decode of every 16-bit window in table slot ``tin`` of
    ``bank`` (csrc/wave.cu: the first length whose code is below
    maxcode + 1, a row outside the group read as the last one): an int32
    (65536,) array of (code length + size) << 8 | symbol, 0 where no code
    matches."""
    nrows = 4 * n_banks
    tslot = tin + 4 * bank
    row = lentab[tslot if 0 <= tslot < nrows else nrows - 1]
    maxc1 = (row >> 15).astype(np.int64)
    base = (row & 0x7FFF).astype(np.int64)
    win = np.arange(1 << 16, dtype=np.int64)
    out = np.zeros(1 << 16, np.int64)
    done = np.zeros(1 << 16, bool)
    toff = _VAL_OFF.get(tin, 194)
    for li in range(16):
        cand = win >> (15 - li)
        hit = ~done & (cand < maxc1[li])
        flat = np.clip(toff + ((cand + base[li]) & 0x7FFF), 0, 355)
        widx = (flat >> 2) + VAL_WORDS * bank
        ok = (widx >= 0) & (widx < values.size)
        word = np.where(ok, values[np.clip(widx, 0, values.size - 1)], 0)
        sym = (word >> ((flat & 3) << 3)) & 0xFF
        out = np.where(hit, ((li + 1 + (sym & 15)) << 8) | sym, out)
        done |= hit
    return out.astype(np.int32)


def _walk(buf: bytes, nbits: int, total: int, slots, tables):
    """The sequential decode of one clean stream by the host walk's rule:
    (err, MCU start bit positions, DC predictors at each start)."""
    dc_slot, ac_slot, comp = slots
    nslots = len(dc_slot)
    limit = nbits + _LIMIT_BITS
    nbuf = len(buf)
    p = s = k = m = 0
    dc = [0, 0, 0]
    starts, preds = [0], [(0, 0, 0)]
    while m < total:
        q = p >> 3
        chunk = buf[q:q + 5] if q < nbuf else b""
        win = (int.from_bytes(chunk + bytes(5 - len(chunk)), "big")
               >> (8 - (p & 7))) & 0xFFFFFFFF
        is_dc = k == 0
        e = tables[(dc_slot if is_dc else ac_slot)[s]][win >> 16]
        if e == 0:
            return True, starts, preds
        n, sym = e >> 8, e & 0xFF
        size = sym & 15
        if is_dc:
            mask = (1 << size) - 1
            ext = (win >> (32 - n)) & mask
            val = ext - (mask if ext < ((1 << size) >> 1) else 0)
            c = comp[s]
            dc[c] = ((dc[c] + val + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
            k = 1
        else:
            run = sym >> 4
            k = k + run + 1 if size else (k + 16 if run == 15 else 64)
        p += n
        if k >= 64:
            k = 0
            s += 1
            if s == nslots:
                s = 0
                m += 1
                if p > limit:
                    return True, starts, preds
                if m < total:
                    starts.append(p)
                    preds.append(tuple(dc))
    return False, starts, preds


def _lane_words(buf: bytes, bit0: int, bit1: int) -> np.ndarray:
    """Bits [bit0, bit1) of a stream, zeros past its bytes, as big-endian
    words with the bits past bit1 zero."""
    n = -(-(bit1 - bit0) // 32)
    need = (bit1 >> 3) + 16
    raw = np.frombuffer(buf[:need] + bytes(max(0, need - len(buf))), np.uint8)
    raw = np.concatenate([raw, np.zeros(-raw.size % 4 + 8, np.uint8)])
    wd = raw.view(">u4").astype(np.uint64)
    bit = bit0 + 32 * np.arange(n, dtype=np.int64)
    idx, r = bit >> 5, (bit & 31).astype(np.uint64)
    v = (((wd[idx] << np.uint64(32)) | wd[idx + 1]) << r
         >> np.uint64(32)) & np.uint64(0xFFFFFFFF)
    rem = bit1 - bit
    keep = np.where(rem >= 32, 0xFFFFFFFF,
                    (0xFFFFFFFF << np.maximum(32 - rem, 0)) & 0xFFFFFFFF)
    return (v & keep.astype(np.uint64)).astype(np.uint32)


def sync_lanes_reference(clean, img, lentab, values, geom, total_mcus: int,
                         n_sub: int, n_pad: int, n_dense: int,
                         subseq_bits: int, mcu_range=None) -> SyncedLanes:
    """Plain version of :func:`sync_lanes`: a sequential walk of each
    stream that records every MCU boundary; lane ``t`` of an image starts
    at its first boundary at or after ``t * subseq_bits``. Same signature
    and results."""
    dev = clean.device
    raw = clean.cpu().numpy().view(np.uint8)
    img_np = img.cpu().numpy().astype(np.int64)
    lt = lentab.cpu().numpy().view(np.uint32)
    vals = values.cpu().numpy().view(np.uint32).astype(np.int64)
    n_banks = lt.shape[0] // 4
    slots = (geom.dc_slot, geom.ac_slot, geom.comp_of_slot)
    lo, hi = mcu_range if mcu_range is not None else (0, total_mcus)
    total = total_mcus
    B = img_np.shape[0]

    word_off, img_base, mcu_start, mcu_count, lane_bank = (
        np.zeros(n_pad, np.int32) for _ in range(5))
    dc_flat = np.zeros((n_pad, 3), np.int32)
    lane_err = np.zeros(n_pad, bool)
    lane_of_mcu = np.zeros((B, total), np.int32)
    dense = np.zeros(n_dense, np.uint32)
    tables = {}
    for i in range(B):
        c0, nbytes, bank, f, T, d0 = (int(img_np[i, j]) for j in (
            I_CLEAN, I_BYTES, I_BANK, I_SUB, I_NSUB, I_DENSE))
        buf = raw[4 * c0:4 * c0 + nbytes].tobytes()
        nbits = 8 * nbytes
        for tin in set(slots[0]) | set(slots[1]):
            if (bank, tin) not in tables:
                tables[bank, tin] = _symbol_table(lt, vals, n_banks, bank,
                                                  tin).tolist()
        rows = {tin: tables[bank, tin] for tin in set(slots[0]) | set(slots[1])}
        err, starts, preds = _walk(buf, nbits, total, slots, rows)
        lanes = slice(f, f + T)
        img_base[lanes] = i * geom.total_blocks
        lane_bank[lanes] = bank
        word_off[lanes] = d0
        if err:
            lane_err[lanes] = True
            lane_of_mcu[i] = f + T - 1
            continue
        q = np.asarray(starts, np.int64)
        start = np.minimum(np.searchsorted(
            q, np.arange(T, dtype=np.int64) * subseq_bits, side="left"),
            total)
        count = np.diff(np.append(start, total))
        mcu_start[lanes] = start
        # lane_of_mcu: the last lane of the image starting at or before m.
        lane_of_mcu[i] = f + np.searchsorted(
            start, np.arange(total), side="right") - 1
        at = d0
        for t in range(T):
            if count[t] <= 0:
                word_off[f + t] = at
                continue
            b = int(q[start[t]])
            nxt = start[t] + count[t]
            e = int(q[nxt]) if nxt < total else nbits + LANE_TAIL_BITS
            s0 = int(start[t])
            if s0 >= hi or s0 + count[t] <= lo:
                word_off[f + t] = at
                continue
            words = _lane_words(buf, b, e)
            word_off[f + t] = at
            mcu_count[f + t] = count[t]
            dc_flat[f + t] = preds[s0]
            dense[at:at + words.size] = words
            at += words.size
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return SyncedLanes(
        dense=t(dense.view(np.int32)), word_off=t(word_off),
        img_base=t(img_base), mcu_start=t(mcu_start), mcu_count=t(mcu_count),
        lane_bank=t(lane_bank), dc_flat=t(dc_flat),
        lane_of_mcu=t(lane_of_mcu), lane_err=t(lane_err),
        rejected=t(np.array([int(lane_err.any())], np.int32)))

