"""Plain NumPy reference of a baseline JPEG decode, from its coefficients.

What a decoder of these streams must give, output byte for byte:
dequantisation, the 8x8 inverse DCT of libjpeg's ``jidctint.c`` ("islow":
13-bit constants, two passes, int32 arithmetic), level shift and clamp,
planes cut to the picture, then the output format of the session API:

- ``native`` for 4:2:0: the Y plane, then U and V interleaved (NV12) at
  the floor-halved chroma size;
- ``rgb``: chroma upsampled by repetition, edge-replicated out to odd
  luma sizes, full-range BT.709 in 16-bit fixed point rounded half up,
  interleaved.

The coefficients come from the benchmark's own content generator
(``harness.content``), the same call that made the streams the program
decodes; nothing here reads anything the program made. ``idct="ifast"``
is the control: libjpeg's ``jidctfst.c``, the lower-precision integer
IDCT (8-bit constants) a faster decoder might be tempted by.

Imports numpy and the benchmark's content generator only.
"""

from __future__ import annotations

import numpy as np

from harness import content

CONST_BITS = 13
PASS1_BITS = 2
FIX = {k: v for k, v in (
    ("0_298631336", 2446), ("0_390180644", 3196), ("0_541196100", 4433),
    ("0_765366865", 6270), ("0_899976223", 7373), ("1_175875602", 9633),
    ("1_501321110", 12299), ("1_847759065", 15137), ("1_961570560", 16069),
    ("2_053119869", 16819), ("2_562915447", 20995), ("3_072711026", 25172))}


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _islow_1d(v, shift):
    """One 8-point pass of jidctint over axis 0 of ``v`` (8, ...) int32."""
    z2, z3 = v[2], v[6]
    z1 = (z2 + z3) * FIX["0_541196100"]
    tmp2 = z1 - z3 * FIX["1_847759065"]
    tmp3 = z1 + z2 * FIX["0_765366865"]
    tmp0 = (v[0] + v[4]) << CONST_BITS
    tmp1 = (v[0] - v[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = v[7], v[5], v[3], v[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX["1_175875602"]
    t0 = t0 * FIX["0_298631336"]
    t1 = t1 * FIX["2_053119869"]
    t2 = t2 * FIX["3_072711026"]
    t3 = t3 * FIX["1_501321110"]
    z1 = z1 * -FIX["0_899976223"]
    z2 = z2 * -FIX["2_562915447"]
    z3 = z3 * -FIX["1_961570560"] + z5
    z4 = z4 * -FIX["0_390180644"] + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return np.stack([_descale(tmp10 + t3, shift), _descale(tmp11 + t2, shift),
                     _descale(tmp12 + t1, shift), _descale(tmp13 + t0, shift),
                     _descale(tmp13 - t0, shift), _descale(tmp12 - t1, shift),
                     _descale(tmp11 - t2, shift), _descale(tmp10 - t3, shift)])


# jidctfst: 8-bit constants, one descale at the end of each pass.
IFAST_BITS = 8
IFAST = {"1_082392200": 277, "1_414213562": 362, "1_847759065": 473,
         "2_613125930": 669}


def _aan_multipliers(q: np.ndarray) -> np.ndarray:
    """jidctfst's dequantisation: each step times its AAN scale factor,
    kept with IFAST_SCALE_BITS (= PASS1_BITS) fraction bits."""
    sf = np.array([1.0] + [np.cos(k * np.pi / 16) * np.sqrt(2)
                           for k in range(1, 8)])
    aan = np.rint(16384 * np.outer(sf, sf)).astype(np.int64).reshape(64)
    return _descale(q.astype(np.int64) * aan, 14 - PASS1_BITS)


def _ifast_mul(x, c):
    return _descale(x * c, IFAST_BITS)


def _ifast_1d(v):
    tmp10, tmp11 = v[0] + v[4], v[0] - v[4]
    tmp13 = v[2] + v[6]
    tmp12 = _ifast_mul(v[2] - v[6], IFAST["1_414213562"]) - tmp13
    tmp0, tmp3 = tmp10 + tmp13, tmp10 - tmp13
    tmp1, tmp2 = tmp11 + tmp12, tmp11 - tmp12
    z13, z10 = v[5] + v[3], v[5] - v[3]
    z11, z12 = v[1] + v[7], v[1] - v[7]
    tmp7 = z11 + z13
    tmp11 = _ifast_mul(z11 - z13, IFAST["1_414213562"])
    z5 = _ifast_mul(z10 + z12, IFAST["1_847759065"])
    tmp10 = _ifast_mul(z12, IFAST["1_082392200"]) - z5
    tmp12 = _ifast_mul(z10, -IFAST["2_613125930"]) + z5
    tmp6 = tmp12 - tmp7
    tmp5 = tmp11 - tmp6
    tmp4 = tmp10 + tmp5
    return np.stack([tmp0 + tmp7, tmp1 + tmp6, tmp2 + tmp5, tmp3 - tmp4,
                     tmp3 + tmp4, tmp2 - tmp5, tmp1 - tmp6, tmp0 - tmp7])


def idct_blocks(coefs: np.ndarray, q: np.ndarray, idct: str = "islow"):
    """(..., 64) natural-order quantised coefficients -> (..., 64) uint8
    samples (row-major 8x8)."""
    shape = coefs.shape
    if idct == "islow":
        mult = q
    elif idct == "ifast":
        mult = _aan_multipliers(q)
    else:
        raise ValueError(f"unknown idct {idct!r}")
    x = coefs.reshape(-1, 8, 8).astype(np.int32) * mult.reshape(8, 8).astype(
        np.int32)
    v = x.transpose(1, 2, 0)  # (row u, col v, block): passes over axis 0
    if idct == "islow":
        cols = _islow_1d(v, CONST_BITS - PASS1_BITS)       # over u: columns
        out = _islow_1d(cols.transpose(1, 0, 2),            # over v: rows
                        CONST_BITS + PASS1_BITS + 3)
    else:
        cols = _ifast_1d(v)
        out = _descale(_ifast_1d(cols.transpose(1, 0, 2)), PASS1_BITS + 3)
    # out is (col x, row y, block): samples[y, x].
    s = np.clip(out.transpose(2, 1, 0) + 128, 0, 255).astype(np.uint8)
    return s.reshape(shape)


def planes(cfg: dict, seed: int, batch: int, slot: int, width: int,
           height: int, idct: str = "islow") -> list:
    """Each component's decoded plane, MCU-padded: (bh*8, bw*8) uint8."""
    coefs = content.coefficients(cfg, seed, batch, slot, width, height)
    qt = content.tables(cfg["quality"])
    out = []
    for ci, co in enumerate(coefs):
        bh, bw = co.shape[:2]
        s = idct_blocks(co, qt[min(ci, 1)], idct)
        out.append(s.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(
            bh * 8, bw * 8))
    return out


# Full-range BT.709, 16-bit fixed point.
FIX_BITS = 16
CR_V = round(1.5748 * (1 << FIX_BITS))
CG_U = round(-0.1873 * (1 << FIX_BITS))
CG_V = round(-0.4681 * (1 << FIX_BITS))
CB_U = round(1.8556 * (1 << FIX_BITS))


def _edge(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    """Edge-replicate up to (h, w), then cut to it."""
    ph, pw = plane.shape
    plane = np.pad(plane, ((0, max(h - ph, 0)), (0, max(w - pw, 0))),
                   mode="edge")
    return plane[:h, :w]


def render(pl: list, width: int, height: int, fmt: str) -> list:
    """The output channels of one 4:2:0 image in ``fmt``, each a 2-D
    uint8 array (rows, row bytes)."""
    y = pl[0][:height, :width]
    cw, ch = width // 2, height // 2
    u = pl[1][:ch, :cw]
    v = pl[2][:ch, :cw]
    if fmt == "native":
        return [y, np.stack([u, v], -1).reshape(ch, 2 * cw)]
    if fmt == "rgb":
        uf = _edge(u.repeat(2, 0).repeat(2, 1), height, width)
        vf = _edge(v.repeat(2, 0).repeat(2, 1), height, width)
        yi = y.astype(np.int32) << FIX_BITS
        ui = uf.astype(np.int32) - 128
        vi = vf.astype(np.int32) - 128
        half = 1 << (FIX_BITS - 1)
        r = (yi + CR_V * vi + half) >> FIX_BITS
        g = (yi + CG_U * ui + CG_V * vi + half) >> FIX_BITS
        b = (yi + CB_U * ui + half) >> FIX_BITS
        rgb = np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)
        return [rgb.reshape(height, 3 * width)]
    raise ValueError(f"unknown output format {fmt!r}")


def decode(cfg: dict, seed: int, batch: int, slot: int, width: int,
           height: int, fmt: str, idct: str = "islow") -> list:
    """The reference's output channels of one image of the corpus."""
    return render(planes(cfg, seed, batch, slot, width, height, idct),
                  width, height, fmt)
