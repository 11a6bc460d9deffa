"""Minimal baseline JPEG *encoder* for test fixtures and benchmarks.

The reference ships only three sample images (data/images/) and no
correctness oracle (SURVEY.md §4). This encoder closes the gap: it can
synthesize valid baseline-DCT streams for the full subsampling matrix
(4:4:4 / 4:4:0 / 4:2:2 / 4:2:0 / 4:1:1 / 4:0:0 — PIL cannot write 440/411),
with arbitrary restart intervals (the parallel axis of the entropy decoder),
and can entropy-encode *given quantized coefficients* directly, enabling
exact coefficient-domain roundtrip tests of the Huffman decoder.

Huffman tables are simple fixed-length canonical tables (DC: 12 symbols at
4 bits; AC: 162 symbols at 8 bits) — valid per ITU-T T.81 Annex C (no
all-ones code is ever assigned) and accepted by libjpeg, at the cost of
compression ratio, which is irrelevant for fixtures.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.zigzag import ZIGZAG_ORDER

# --- fixed canonical Huffman tables ------------------------------------

DC_BITS = np.array([0, 0, 0, 12] + [0] * 12, np.uint8)  # 12 codes of len 4
DC_VALUES = np.arange(12, dtype=np.uint8)

_AC_SYMBOLS = [0x00, 0xF0] + [
    (r << 4) | s for r in range(16) for s in range(1, 11)
]
AC_BITS = np.array([0] * 7 + [len(_AC_SYMBOLS)] + [0] * 8, np.uint8)
AC_VALUES = np.array(_AC_SYMBOLS, np.uint8)

# Example luminance quant table (ITU-T T.81 Table K.1), zigzag file order
# applied at write time.
QTABLE_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.uint8)
QTABLE_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99], np.uint8)

# Sampling-factor layouts per subsampling name.
SAMPLING = {
    "444": [(1, 1), (1, 1), (1, 1)],
    "440": [(1, 2), (1, 1), (1, 1)],
    "422": [(2, 1), (1, 1), (1, 1)],
    "420": [(2, 2), (1, 1), (1, 1)],
    "411": [(4, 1), (1, 1), (1, 1)],
    "400": [(1, 1)],
}


def _build_codes(bits: np.ndarray, values: np.ndarray):
    codes = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(int(bits[length - 1])):
            codes[int(values[k])] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


DC_CODES = _build_codes(DC_BITS, DC_VALUES)
AC_CODES = _build_codes(AC_BITS, AC_VALUES)

# Alternate table set (same symbols, one bit longer codes) — a second
# Huffman "encoder identity" for mixed-table corpora tests.
DC_BITS_ALT = np.array([0, 0, 0, 0, 12] + [0] * 11, np.uint8)
AC_BITS_ALT = np.array([0] * 8 + [len(_AC_SYMBOLS)] + [0] * 7, np.uint8)
DC_CODES_ALT = _build_codes(DC_BITS_ALT, DC_VALUES)
AC_CODES_ALT = _build_codes(AC_BITS_ALT, AC_VALUES)

# table_variant -> (dc_bits, dc_values, ac_bits, ac_values, dc_codes,
# ac_codes); variant 1 produces byte-different DHTs and codes, so streams
# mixing variants exercise per-image table banks in the wave.
TABLE_VARIANTS = {
    0: (DC_BITS, DC_VALUES, AC_BITS, AC_VALUES, DC_CODES, AC_CODES),
    1: (DC_BITS_ALT, DC_VALUES, AC_BITS_ALT, AC_VALUES, DC_CODES_ALT,
        AC_CODES_ALT),
}


class _BitWriter:
    """MSB-first bit writer with 0xFF byte stuffing (T.81 F.1.2.3)."""

    def __init__(self) -> None:
        self.out = bytearray()
        self._acc = 0
        self._nbits = 0

    def put(self, code: int, length: int) -> None:
        self._acc = (self._acc << length) | (code & ((1 << length) - 1))
        self._nbits += length
        while self._nbits >= 8:
            byte = (self._acc >> (self._nbits - 8)) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0x00)
            self._nbits -= 8
        self._acc &= (1 << self._nbits) - 1

    def pad_to_byte(self) -> None:
        # Pad the final partial byte with 1-bits (T.81 F.1.2.3).
        while self._nbits % 8:
            self.put(1, 1)


def _category(v: int) -> int:
    return int(v).bit_length() if v > 0 else int(-v).bit_length()


def _encode_block(w: _BitWriter, block_zz: np.ndarray, dc_pred: int,
                  dc_codes=DC_CODES, ac_codes=AC_CODES) -> int:
    """Encode one block given zigzag-ordered quantized coefficients."""
    DC_CODES, AC_CODES = dc_codes, ac_codes
    dc = int(block_zz[0])
    diff = dc - dc_pred
    s = _category(diff)
    code, length = DC_CODES[s]
    w.put(code, length)
    if s:
        v = diff if diff > 0 else diff + (1 << s) - 1
        w.put(v, s)
    run = 0
    last_nz = 0
    nz = np.flatnonzero(block_zz[1:])
    last_nz = (nz[-1] + 1) if nz.size else 0
    k = 1
    while k <= last_nz:
        v = int(block_zz[k])
        if v == 0:
            run += 1
        else:
            while run >= 16:
                code, length = AC_CODES[0xF0]
                w.put(code, length)
                run -= 16
            s = _category(v)
            code, length = AC_CODES[(run << 4) | s]
            w.put(code, length)
            bits = v if v > 0 else v + (1 << s) - 1
            w.put(bits, s)
            run = 0
        k += 1
    if last_nz < 63:
        code, length = AC_CODES[0x00]
        w.put(code, length)
    return dc


def fdct_quantize(plane: np.ndarray, qtable_nat: np.ndarray) -> np.ndarray:
    """Forward float DCT-II + quantize. plane: (H8, W8) uint8 (dims multiples
    of 8). Returns (bh, bw, 64) int zigzag-ordered quantized coefficients."""
    h, w = plane.shape
    bh, bw = h // 8, w // 8
    n = np.arange(8)
    c = np.cos((2 * n[None, :] + 1) * n[:, None] * np.pi / 16) * 0.5
    c[0] *= 1 / np.sqrt(2)
    blocks = plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).astype(np.float64) - 128.0
    f = np.einsum("ij,bcjk,lk->bcil", c, blocks, c)
    q = np.round(f / qtable_nat.reshape(8, 8)).astype(np.int32)
    return q.reshape(bh, bw, 64)[..., ZIGZAG_ORDER]


def _optimal_table(freq: np.ndarray):
    """Optimal length-limited canonical Huffman table from symbol counts
    (ITU-T T.81 Annex K.2, the libjpeg jpeg_gen_optimal_table algorithm):
    returns (bits[16], values[n]). A reserved 257th symbol with count 1
    guarantees the all-ones code is never assigned (Annex C requirement)."""
    nsym = len(freq)
    f = np.zeros(nsym + 1, np.int64)
    f[:nsym] = freq
    f[nsym] = 1  # reserved
    codesize = np.zeros(nsym + 1, np.int32)
    others = np.full(nsym + 1, -1, np.int32)
    while True:
        nz = np.flatnonzero(f > 0)
        if nz.size < 2:
            break
        order = nz[np.lexsort((-nz, f[nz]))]  # lowest count, highest index
        v1, v2 = int(order[0]), int(order[1])
        f[v1] += f[v2]
        f[v2] = 0
        codesize[v1] += 1
        while others[v1] >= 0:
            v1 = others[v1]
            codesize[v1] += 1
        others[v1] = v2
        codesize[v2] += 1
        while others[v2] >= 0:
            v2 = others[v2]
            codesize[v2] += 1
    counts = np.zeros(max(33, int(codesize.max()) + 1), np.int32)
    for cs in codesize[codesize > 0]:
        counts[cs] += 1
    # Length-limit to 16 (K.2 adjustment): move pairs up from the longest.
    for length in range(len(counts) - 1, 16, -1):
        while counts[length] > 0:
            j = length - 2
            while counts[j] == 0:
                j -= 1
            counts[length] -= 2
            counts[length - 1] += 1
            counts[j + 1] += 2
            counts[j] -= 1
    # Drop the reserved symbol from the longest used length.
    for length in range(16, 0, -1):
        if counts[length]:
            counts[length] -= 1
            break
    bits = counts[1:17].astype(np.uint8)
    syms = np.flatnonzero(codesize[:nsym] > 0)
    values = syms[np.lexsort((syms, codesize[syms]))].astype(np.uint8)
    assert int(bits.sum()) == len(values)
    return bits, values


def _count_block(dc_freq, ac_freq, block_zz: np.ndarray, dc_pred: int) -> int:
    """Symbol-frequency twin of _encode_block."""
    dc = int(block_zz[0])
    dc_freq[_category(dc - dc_pred)] += 1
    nz = np.flatnonzero(block_zz[1:])
    last_nz = (nz[-1] + 1) if nz.size else 0
    run = 0
    k = 1
    while k <= last_nz:
        v = int(block_zz[k])
        if v == 0:
            run += 1
        else:
            while run >= 16:
                ac_freq[0xF0] += 1
                run -= 16
            ac_freq[(run << 4) | _category(v)] += 1
            run = 0
        k += 1
    if last_nz < 63:
        ac_freq[0x00] += 1
    return dc


def encode_coefficients(
        coeff_planes_zz: Sequence[np.ndarray],
        sampling: Sequence[Tuple[int, int]],
        width: int, height: int,
        qtables_zz: Sequence[np.ndarray],
        qtable_ids: Sequence[int],
        restart_interval: int = 0,
        table_variant: int = 0,
        optimize: bool = False) -> bytes:
    """Assemble a baseline JPEG from zigzag-ordered quantized coefficient
    planes (bh, bw, 64). Plane block dims must be MCU-padded for the given
    sampling layout."""
    ncomp = len(coeff_planes_zz)
    max_h = max(h for h, v in sampling)
    max_v = max(v for h, v in sampling)
    mcus_w = (width + max_h * 8 - 1) // (max_h * 8)
    mcus_h = (height + max_v * 8 - 1) // (max_v * 8)

    out = bytearray()
    out += b"\xff\xd8"  # SOI

    # DQT segments.
    emitted = set()
    for qid, qt in zip(qtable_ids, qtables_zz):
        if qid in emitted:
            continue
        emitted.add(qid)
        out += b"\xff\xdb" + struct.pack(">H", 2 + 1 + 64) + bytes([qid])
        out += bytes(np.asarray(qt, np.uint8).tolist())

    # SOF0.
    out += b"\xff\xc0" + struct.pack(">HBHHB", 2 + 6 + 3 * ncomp, 8,
                                     height, width, ncomp)
    for i, (h, v) in enumerate(sampling):
        out += bytes([i + 1, (h << 4) | v, qtable_ids[i]])

    # Entropy-coded scan plan (needed early for the optimize counting pass).
    interleaved = ncomp > 1
    if interleaved:
        total_mcus = mcus_w * mcus_h
        plan = [(ci, v, u) for ci, (h, vv) in enumerate(sampling)
                for v in range(vv) for u in range(h)]
    else:
        bw_ = (width + 7) // 8
        bh_ = (height + 7) // 8
        mcus_w = bw_
        total_mcus = bw_ * bh_
        plan = [(0, 0, 0)]
    n_tables = 1 if ncomp == 1 else 2
    ri = restart_interval or total_mcus

    if optimize:
        # Per-image optimal tables (like the reference's bundled corpus —
        # data/images/mug_*.jpg carry libjpeg-optimized DHTs, not Annex K):
        # one counting pass, then K.2 table construction per table id.
        dc_freq = [np.zeros(16, np.int64) for _ in range(n_tables)]
        ac_freq = [np.zeros(256, np.int64) for _ in range(n_tables)]
        dc_pred = [0] * ncomp
        for m in range(total_mcus):
            if m and m % ri == 0:
                dc_pred = [0] * ncomp
            my, mx = divmod(m, mcus_w)
            for ci, v, u in plan:
                h_i, v_i = sampling[ci]
                by, bx = ((my * v_i + v, mx * h_i + u) if interleaved
                          else (my, mx))
                tid = 0 if ci == 0 else 1
                dc_pred[ci] = _count_block(dc_freq[tid], ac_freq[tid],
                                           coeff_planes_zz[ci][by, bx],
                                           dc_pred[ci])
        tables = []
        for tid in range(n_tables):
            db, dv = _optimal_table(dc_freq[tid])
            ab, av = _optimal_table(ac_freq[tid])
            tables.append((db, dv, ab, av,
                           _build_codes(db, dv), _build_codes(ab, av)))
    else:
        dc_bits, dc_vals, ac_bits, ac_vals, dc_codes, ac_codes = \
            TABLE_VARIANTS[table_variant]
        tables = [(dc_bits, dc_vals, ac_bits, ac_vals, dc_codes,
                   ac_codes)] * n_tables

    # DHT: table id 0 (DC+AC) and, for color, id 1.
    for tid, (db, dv, ab, av, _dcc, _acc) in enumerate(tables):
        out += b"\xff\xc4" + struct.pack(">H", 2 + 1 + 16 + len(dv)) \
            + bytes([tid]) + bytes(db.tolist()) + bytes(dv.tolist())
        out += b"\xff\xc4" + struct.pack(">H", 2 + 1 + 16 + len(av)) \
            + bytes([0x10 | tid]) + bytes(ab.tolist()) + bytes(av.tolist())

    if restart_interval:
        out += b"\xff\xdd" + struct.pack(">HH", 4, restart_interval)

    # SOS.
    out += b"\xff\xda" + struct.pack(">HB", 2 + 1 + 2 * ncomp + 3, ncomp)
    for i in range(ncomp):
        tid = 0 if i == 0 else 1
        out += bytes([i + 1, (tid << 4) | tid])
    out += bytes([0, 63, 0])

    w = _BitWriter()
    dc_pred = [0] * ncomp
    rst = 0
    ri = restart_interval or total_mcus
    for m in range(total_mcus):
        if m and m % ri == 0:
            w.pad_to_byte()
            out += w.out
            w = _BitWriter()
            out += bytes([0xFF, 0xD0 + (rst % 8)])
            rst += 1
            dc_pred = [0] * ncomp
        my, mx = divmod(m, mcus_w)
        for ci, v, u in plan:
            h_i, v_i = sampling[ci]
            if interleaved:
                by, bx = my * v_i + v, mx * h_i + u
            else:
                by, bx = my, mx
            t = tables[0 if ci == 0 else 1]
            dc_pred[ci] = _encode_block(w, coeff_planes_zz[ci][by, bx],
                                        dc_pred[ci], t[4], t[5])
    w.pad_to_byte()
    out += w.out
    out += b"\xff\xd9"  # EOI
    return bytes(out)


def _pad_plane(plane: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """Edge-pad a sample plane to (bh*8, bw*8)."""
    h, w = plane.shape
    return np.pad(plane, ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge")


def encode_planes(planes: Sequence[np.ndarray], css: str,
                  restart_interval: int = 0,
                  qtables_nat: Optional[Sequence[np.ndarray]] = None,
                  table_variant: int = 0, optimize: bool = False) -> bytes:
    """Encode uint8 sample planes (already subsampled: Y at (H, W), chroma at
    the css-appropriate dims) into a baseline JPEG."""
    sampling = SAMPLING[css]
    ncomp = len(sampling)
    assert len(planes) == ncomp, (len(planes), ncomp)
    height, width = planes[0].shape
    max_h = max(h for h, v in sampling)
    max_v = max(v for h, v in sampling)
    mcus_w = (width + max_h * 8 - 1) // (max_h * 8)
    mcus_h = (height + max_v * 8 - 1) // (max_v * 8)

    if qtables_nat is None:
        from ..core.zigzag import dezigzag
        qtables_nat = [dezigzag(QTABLE_LUMA.astype(np.int32))]
        if ncomp > 1:
            qtables_nat.append(dezigzag(QTABLE_CHROMA.astype(np.int32)))
    qtable_ids = [0] + [1] * (ncomp - 1) if len(qtables_nat) > 1 else [0] * ncomp

    coeff_planes = []
    for ci, (h_i, v_i) in enumerate(sampling):
        bh = mcus_h * v_i
        bw = mcus_w * h_i
        padded = _pad_plane(planes[ci], bh, bw)
        qt = qtables_nat[min(ci, len(qtables_nat) - 1)]
        coeff_planes.append(fdct_quantize(padded, np.asarray(qt)))

    qtables_zz = [np.asarray(q).reshape(64)[ZIGZAG_ORDER] for q in qtables_nat]
    if len(qtables_zz) == 1 and ncomp > 1:
        qtables_zz = qtables_zz * 2
    return encode_coefficients(coeff_planes, sampling, width, height,
                               qtables_zz, qtable_ids, restart_interval,
                               table_variant=table_variant, optimize=optimize)


def random_planes(css: str, width: int, height: int, seed: int = 0):
    """Random (smooth-ish) uint8 planes for the given css at proper dims."""
    rng = np.random.default_rng(seed)
    hf, vf = {"444": (1, 1), "440": (1, 2), "422": (2, 1),
              "420": (2, 2), "411": (4, 1), "400": (1, 1)}[css]
    planes = [rng.integers(0, 256, (height, width), np.uint8)]
    if css != "400":
        planes.append(rng.integers(0, 256, (height // vf, width // hf), np.uint8))
        planes.append(rng.integers(0, 256, (height // vf, width // hf), np.uint8))
    return planes


def photo_planes(css: str, width: int, height: int, seed: int = 0):
    """Photographic-statistics uint8 planes: textured luma (gradient +
    moderate noise), smooth low-variance chroma. Uniform-noise planes
    (random_planes) make luma and chroma streams statistically identical;
    real photos — like the reference's bundled mug corpus — carry exactly
    this luma/chroma asymmetry, which matters for any Huffman
    self-synchronization analysis (tools history: the removed sync pass)."""
    rng = np.random.default_rng(seed)
    hf, vf = {"444": (1, 1), "440": (1, 2), "422": (2, 1),
              "420": (2, 2), "411": (4, 1), "400": (1, 1)}[css]
    yy, xx = np.mgrid[0:height, 0:width]
    base = (96 + 64 * np.sin(xx / 17.0) * np.cos(yy / 23.0)
            + 0.2 * xx + 0.1 * yy)
    y = np.clip(base + rng.normal(0, 28, (height, width)), 0,
                255).astype(np.uint8)
    planes = [y]
    if css != "400":
        ch, cw = height // vf, width // hf
        cy, cx = np.mgrid[0:ch, 0:cw]
        for phase in (0.0, 2.0):
            c = 128 + 24 * np.sin(cx / 31.0 + phase) * np.cos(cy / 29.0)
            c = np.clip(c + rng.normal(0, 2.5, (ch, cw)), 0, 255)
            planes.append(c.astype(np.uint8))
    return planes
