"""An independent numpy decode: the reference the smoke run and the tests
hold the port's device path against.

Native entropy decode (``runtime.host_decode``), then everything else in
numpy, written here from the standards and sharing no code with the
port's torch functions (``ops/*.py``) or its kernels: dequantisation and
the fixed-point "islow" 8x8 inverse DCT of libjpeg's ``jidctint.c``
(13-bit constants, two passes), nearest-neighbour chroma upsampling, the
16-bit fixed-point full-range BT.709 conversion, and the five output
layouts with the reference's ROI rule. Results equal the JAX package's
``core.golden.decode`` byte for byte.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core.bitstream import JpegStreamParser
from ..runtime import host_decode
from ..status import RocJpegError, Status
from ..types import ChromaSubsampling as CSS
from ..types import CropRectangle, OutputFormat

# Natural (row-major) index of the k-th zigzag coefficient (T.81 Figure 5),
# generated by walking the anti-diagonals.
_ZIGZAG = np.array(sorted(
    range(64), key=lambda i: (i // 8 + i % 8,
                              i // 8 if (i // 8 + i % 8) % 2 else i % 8)))

# jidctint.c: FIX(x) = round(x * 2**13).
_C = {name: int(round(float(name) * (1 << 13))) for name in (
    "0.298631336", "0.390180644", "0.541196100", "0.765366865",
    "0.899976223", "1.175875602", "1.501321110", "1.847759065",
    "1.961570560", "2.053119869", "2.562915447", "3.072711026")}

# Chroma (horizontal, vertical) subsampling per format.
_FACTORS = {CSS.CSS_444: (1, 1), CSS.CSS_440: (1, 2), CSS.CSS_422: (2, 1),
            CSS.CSS_420: (2, 2)}


def _idct_1d(x, shift: int):
    """jidctint.c's 8-point pass over axis 0 of an int32 (8, ...) array."""
    z1 = (x[2] + x[6]) * _C["0.541196100"]
    tmp2 = z1 - x[6] * _C["1.847759065"]
    tmp3 = z1 + x[2] * _C["0.765366865"]
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    even = (tmp0 + tmp3, tmp1 + tmp2, tmp1 - tmp2, tmp0 - tmp3)

    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _C["1.175875602"]
    z1 = z1 * -_C["0.899976223"]
    z2 = z2 * -_C["2.562915447"]
    z3 = z3 * -_C["1.961570560"] + z5
    z4 = z4 * -_C["0.390180644"] + z5
    odd = (t3 * _C["1.501321110"] + z1 + z4, t2 * _C["3.072711026"] + z2 + z3,
           t1 * _C["2.053119869"] + z2 + z4, t0 * _C["0.298631336"] + z1 + z3)

    half = 1 << (shift - 1)
    out = [(e + o + half) >> shift for e, o in zip(even, odd)]
    out += [(e - o + half) >> shift for e, o in zip(even[::-1], odd[::-1])]
    return np.stack(out)


def idct_plane(coeffs: np.ndarray, quant_zz: np.ndarray) -> np.ndarray:
    """(bh, bw, 64) natural-order int16 coefficients and a zigzag-order
    quant table -> the (bh * 8, bw * 8) uint8 sample plane."""
    bh, bw = coeffs.shape[:2]
    quant = np.zeros(64, np.int32)
    quant[_ZIGZAG] = quant_zz
    x = coeffs.astype(np.int32) * quant
    x = x.reshape(bh, bw, 8, 8).transpose(2, 3, 0, 1)  # (row, col, bh, bw)
    x = _idct_1d(x, 13 - 2)                            # columns: over rows
    x = _idct_1d(x.transpose(1, 0, 2, 3), 13 + 2 + 3)  # rows: over columns
    x = np.clip(x + 128, 0, 255).astype(np.uint8)      # (col, row, bh, bw)
    return x.transpose(2, 1, 3, 0).reshape(bh * 8, bw * 8)


def _upsample(plane, hf: int, vf: int, h: int, w: int):
    """Nearest-neighbour upsample, edge-replicated up to (h, w)."""
    rows = np.minimum(np.arange(h) // vf, plane.shape[0] - 1)
    cols = np.minimum(np.arange(w) // hf, plane.shape[1] - 1)
    return plane[rows[:, None], cols[None, :]]


def _to_rgb(y, u, v):
    """Full-range BT.709 in 16-bit fixed point, round half up."""
    yi = y.astype(np.int64) * 65536 + 32768
    ui = u.astype(np.int64) - 128
    vi = v.astype(np.int64) - 128
    r = (yi + round(1.5748 * 65536) * vi) >> 16
    g = (yi + round(-0.1873 * 65536) * ui + round(-0.4681 * 65536) * vi) >> 16
    b = (yi + round(1.8556 * 65536) * ui) >> 16
    return [np.clip(c, 0, 255).astype(np.uint8) for c in (r, g, b)]


def _interleave(*planes):
    """(H, W) planes -> (H, n * W), samples interleaved along each row."""
    h, w = planes[0].shape
    return np.stack(planes, axis=-1).reshape(h, len(planes) * w)


def render(css, planes, width: int, height: int, fmt,
           crop: Optional[CropRectangle] = None
           ) -> List[Tuple[np.ndarray, int]]:
    """MCU-padded (y, u, v) planes -> the [(array, pitch), ...] channel list
    of one output format."""
    css, fmt = CSS(css), OutputFormat(fmt)
    if css not in _FACTORS and css != CSS.CSS_400:
        raise RocJpegError(Status.JPEG_NOT_SUPPORTED,
                           f"chroma subsampling {css.name} is not supported")
    left = top = 0
    w, h = width, height
    if crop is not None and 0 < crop.width <= width \
            and 0 < crop.height <= height:
        left, top, w, h = crop.left, crop.top, crop.width, crop.height
    y = planes[0][top:top + h, left:left + w]
    if css == CSS.CSS_400:
        if fmt == OutputFormat.RGB:
            return [(_interleave(y, y, y), 3 * w)]
        if fmt == OutputFormat.RGB_PLANAR:
            return [(y, w)] * 3
        return [(y, w)]
    hf, vf = _FACTORS[css]
    cw, ch = w // hf, h // vf
    u, v = (p[top // vf:top // vf + ch, left // hf:left // hf + cw]
            for p in planes[1:3])
    if fmt == OutputFormat.Y:
        return [(y, w)]
    if fmt == OutputFormat.YUV_PLANAR:
        return [(y, w), (u, cw), (v, cw)]
    if fmt == OutputFormat.NATIVE:
        if css == CSS.CSS_422:  # packed YUYV
            if w % 2:
                raise ValueError("packed YUYV needs an even width")
            pairs = w // 2
            return [(_interleave(y[:, 0:2 * pairs:2], u[:, :pairs],
                                 y[:, 1:2 * pairs:2], v[:, :pairs]), 2 * w)]
        if css == CSS.CSS_420:  # NV12
            return [(y, w), (_interleave(u, v), w)]
        return [(y, w), (u, w), (v, w)]
    r, g, b = _to_rgb(y, _upsample(u, hf, vf, h, w), _upsample(v, hf, vf, h, w))
    if fmt == OutputFormat.RGB:
        return [(_interleave(r, g, b), 3 * w)]
    return [(r, w), (g, w), (b, w)]


def decode(data: bytes, output_format=OutputFormat.NATIVE,
           crop: Optional[CropRectangle] = None
           ) -> List[Tuple[np.ndarray, int]]:
    """Decode one JPEG byte stream into the channel list
    [(array, pitch), ...] of ``output_format``."""
    p = JpegStreamParser().parse(data)
    planes = []
    for ci, coeffs in enumerate(host_decode.decode_coefficients(p)):
        qid = p.components[ci].quantiser_table_selector
        if not p.load_quantiser_table[qid]:
            raise RocJpegError(Status.BAD_JPEG,
                               f"quant table {qid} not loaded")
        planes.append(idct_plane(coeffs, p.quantiser_tables[qid]))
    return render(p.chroma_subsampling, planes, p.picture_width,
                  p.picture_height, output_format, crop)
