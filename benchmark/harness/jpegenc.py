"""A baseline JPEG encoder in vectorised NumPy: the benchmark's own.

It writes what libjpeg writes at its defaults (``cjpeg -quality Q``):
JFIF, the Annex K quantisation tables scaled as libjpeg scales them, the
Annex K ("standard") Huffman tables, one interleaved sequential scan,
and a restart marker every ``restart_mcus`` MCUs where asked (0: none, as
libjpeg writes by default). The forward DCT is the orthonormal one in
float32, rounded to the nearest step; the benchmark's reference decodes
the same quantised coefficients (``harness.content``), so nothing here
has to match libjpeg's integer DCT bit for bit.

Nothing here imports the program under test: the streams are the
benchmark's inputs.
"""

from __future__ import annotations

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# ITU T.81 Annex K.1, natural order.
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.full(64, 99)
CHROMA_Q.reshape(8, 8)[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66],
                                  [24, 26, 56, 99], [47, 66, 99, 99]]

# ITU T.81 Annex K.3: (BITS, HUFFVAL) of DC luma, DC chroma, AC luma,
# AC chroma.
_AC_LUMA_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_AC_CHROMA_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
HUFF_TABLES = {
    "dc0": ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
            bytes(range(12))),
    "dc1": ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
            bytes(range(12))),
    "ac0": ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
            _AC_LUMA_VALS),
    "ac1": ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
            _AC_CHROMA_VALS),
}

# Magnitude category (bit length) of |v| for every |v| a baseline
# coefficient or DC difference can have.
_CATEGORY = np.zeros(1 << 16, np.int64)
_CATEGORY[1:] = np.floor(np.log2(np.arange(1, 1 << 16))).astype(np.int64) + 1


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's ``jpeg_quality_scaling`` of an Annex K table, clamped to
    1..255 as with ``force_baseline``."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _codes(bits, vals):
    """(code, length) arrays indexed by symbol, from (BITS, HUFFVAL)."""
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            code_of[vals[k]] = code
            len_of[vals[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


_CODES = {name: _codes(*t) for name, t in HUFF_TABLES.items()}


def _fields(values, sizes, code_of, len_of, symbols):
    """Bit fields (value, length) of Huffman symbols followed by their
    ``sizes`` appended bits of ``values`` (negatives as one's complement,
    T.81 F.1.2.1)."""
    extra = (values - (values < 0)) & ((1 << sizes) - 1)
    return (code_of[symbols] << sizes) | extra, len_of[symbols] + sizes


def encode_scan(blocks: np.ndarray, comp: np.ndarray, mcu: np.ndarray,
                chroma: np.ndarray, restart_mcus: int = 0,
                image=None) -> list:
    """The entropy-coded segments of interleaved scans, one an image,
    byte-stuffed, with RST markers between restart intervals.

    blocks: (N, 64) quantised coefficients in zigzag order, in scan order,
    image after image; comp: (N,) component index of each block; mcu: (N,)
    its MCU index within its image; chroma: (N,) whether it takes the
    chroma tables (table 1); image: (N,) its image (default: one)."""
    n = len(blocks)
    image = np.zeros(n, np.int64) if image is None else np.asarray(image)
    local = mcu // restart_mcus if restart_mcus else np.zeros(n, np.int64)
    # Intervals, numbered across images: each starts a DC prediction and
    # a byte.
    change = np.ones(n, bool)
    change[1:] = (image[1:] != image[:-1]) | (local[1:] != local[:-1])
    seg = np.cumsum(change) - 1
    seg_image = image[change]

    # DC differences, the predictor of each component reset at each
    # restart interval.
    dc = blocks[:, 0].astype(np.int64)
    diff = np.empty(n, np.int64)
    for c in np.unique(comp):
        idx = np.flatnonzero(comp == c)
        seq = dc[idx]
        d = np.diff(seq, prepend=0)
        first = np.ones(len(idx), bool)
        first[1:] = seg[idx][1:] != seg[idx][:-1]
        d[first] = seq[first]
        diff[idx] = d
    dsize = _CATEGORY[np.abs(diff)]

    # AC: each nonzero coefficient with its zero run, ZRLs for runs > 15,
    # and an EOB where a block ends in zeros.
    b_i, k_i = np.nonzero(blocks[:, 1:])
    k_i = k_i + 1
    v_i = blocks[b_i, k_i].astype(np.int64)
    newblock = np.ones(len(b_i), bool)
    newblock[1:] = b_i[1:] != b_i[:-1]
    prev_k = np.zeros(len(b_i), np.int64)
    prev_k[~newblock] = k_i[:-1][~newblock[1:]]
    run = k_i - prev_k - 1
    zrl = run >> 4
    m_i = 1 + zrl
    last_i = np.flatnonzero(np.append(newblock[1:], True))
    last_k = np.zeros(n, np.int64)
    last_k[b_i[last_i]] = k_i[last_i]
    eob = last_k < 63
    per_block = 1 + np.bincount(b_i, weights=m_i, minlength=n).astype(
        np.int64) + eob
    start = np.concatenate([[0], np.cumsum(per_block)[:-1]])
    total = int(per_block.sum())

    vals = np.zeros(total, np.int64)
    lens = np.zeros(total, np.int64)
    tab = chroma.astype(np.int64)

    for t in (0, 1):
        code_of, len_of = _CODES[f"dc{t}"]
        sel = np.flatnonzero(tab == t)
        f, ln = _fields(diff[sel], dsize[sel], code_of, len_of, dsize[sel])
        vals[start[sel]] = f
        lens[start[sel]] = ln

    cum_m = np.cumsum(m_i)
    first_i = np.flatnonzero(newblock)
    block_excl = np.zeros(len(b_i), np.int64)
    block_excl[first_i] = cum_m[first_i] - m_i[first_i]
    block_excl = np.maximum.accumulate(block_excl) if len(b_i) else block_excl
    pos_i = start[b_i] + cum_m - block_excl
    asize = _CATEGORY[np.abs(v_i)]
    sym = ((run & 15) << 4) | asize
    for t in (0, 1):
        code_of, len_of = _CODES[f"ac{t}"]
        sel = np.flatnonzero(tab[b_i] == t)
        f, ln = _fields(v_i[sel], asize[sel], code_of, len_of, sym[sel])
        vals[pos_i[sel]] = f
        lens[pos_i[sel]] = ln
        # ZRLs fill the zrl_i slots before each coefficient.
        zsel = sel[zrl[sel] > 0]
        if len(zsel):
            reps = zrl[zsel]
            owner = np.repeat(pos_i[zsel], reps)
            first = np.repeat(np.cumsum(reps) - reps, reps)
            back = np.repeat(reps, reps) - (np.arange(len(owner)) - first)
            vals[owner - back] = code_of[0xF0]
            lens[owner - back] = len_of[0xF0]
        esel = np.flatnonzero((tab == t) & eob)
        epos = start[esel] + per_block[esel] - 1
        vals[epos] = code_of[0x00]
        lens[epos] = len_of[0x00]

    # Bit positions: each restart interval starts on a byte boundary, and
    # its last byte is padded with 1-bits (T.81 F.1.2.3).
    sym_seg = np.repeat(seg, per_block)
    nseg = int(seg[-1]) + 1 if n else 0
    seg_bits = np.bincount(sym_seg, weights=lens, minlength=nseg).astype(
        np.int64)
    seg_bytes = (seg_bits + 7) // 8
    seg_start = np.concatenate([[0], np.cumsum(seg_bytes)[:-1]]) * 8
    excl = np.cumsum(lens) - lens
    seg_first = np.concatenate([[0], np.cumsum(np.bincount(
        sym_seg, minlength=nseg))[:-1]])
    pos = seg_start[sym_seg] + excl - excl[seg_first][sym_seg]
    pad = seg_bytes * 8 - seg_bits
    has_pad = pad > 0
    vals = np.concatenate([vals, (1 << pad[has_pad]) - 1])
    lens = np.concatenate([lens, pad[has_pad]])
    pos = np.concatenate([pos, (seg_start + seg_bits)[has_pad]])

    nbytes = int(seg_bytes.sum())
    nwords = (nbytes + 3) // 4 + 1
    w = pos >> 5
    end = (pos & 31) + lens
    fits = end <= 32
    lo = np.where(fits, vals << np.maximum(32 - end, 0),
                  vals >> np.maximum(end - 32, 0))
    hi = np.where(fits, 0, (vals << np.maximum(64 - end, 0)) & 0xFFFFFFFF)
    # The fields occupy disjoint bits, so summing them ORs them; float64
    # holds every sum below 2**32 exactly.
    words = (np.bincount(w, weights=lo.astype(np.float64), minlength=nwords)
             + np.bincount(w + 1, weights=hi.astype(np.float64),
                           minlength=nwords + 1)[:nwords])
    raw = words.astype(np.uint64).astype(">u4").view(np.uint8)[:nbytes]

    scans = []
    bounds = np.flatnonzero(np.diff(seg_image)) + 1
    for segs in np.split(np.arange(nseg), bounds):
        lo = seg_start[segs[0]] // 8
        part = raw[lo:seg_start[segs[-1]] // 8 + seg_bytes[segs[-1]]]
        ff = np.flatnonzero(part == 0xFF)
        out = np.insert(part, ff + 1, 0)
        if len(segs) > 1:
            # RST markers at the start of every interval but the first, at
            # offsets moved by the stuffing before them.
            starts = seg_start[segs[1:]] // 8 - lo
            moved = starts + np.searchsorted(ff, starts)
            k = len(segs) - 1
            marks = np.stack([np.full(k, 0xFF), 0xD0 + (np.arange(k) % 8)],
                             1).reshape(-1)
            out = np.insert(out, np.repeat(moved, 2), marks.astype(np.uint8))
        scans.append(out.tobytes())
    return scans


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") \
        + payload


def write_jpeg(width: int, height: int, sampling, qtables, scan: bytes,
               restart_mcus: int = 0) -> bytes:
    """A whole JFIF file around ``scan``: ``sampling`` is each
    component's (h, v) factors (component 0 takes quantisation and
    Huffman tables 0, the others tables 1); ``qtables`` are the two
    natural-order tables."""
    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
                                 b"\x00\x00")]
    dqt = b"".join(bytes([t]) + bytes(np.asarray(q)[ZIGZAG].astype(np.uint8))
                   for t, q in enumerate(qtables))
    out.append(_segment(0xDB, dqt))
    sof = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big") \
        + bytes([len(sampling)])
    for ci, (h, v) in enumerate(sampling):
        sof += bytes([ci + 1, (h << 4) | v, min(ci, 1)])
    out.append(_segment(0xC0, sof))
    dht = b""
    for cls, name in ((0, "dc0"), (0, "dc1"), (1, "ac0"), (1, "ac1")):
        bits, vals = HUFF_TABLES[name]
        dht += bytes([(cls << 4) | int(name[-1])]) + bytes(bits) + vals
    out.append(_segment(0xC4, dht))
    if restart_mcus:
        out.append(_segment(0xDD, restart_mcus.to_bytes(2, "big")))
    sos = bytes([len(sampling)])
    for ci in range(len(sampling)):
        t = min(ci, 1)
        sos += bytes([ci + 1, (t << 4) | t])
    out.append(_segment(0xDA, sos + bytes([0, 63, 0])))
    out += [scan, b"\xff\xd9"]
    return b"".join(out)
