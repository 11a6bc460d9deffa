"""Photo-like images drawn from a seed, as quantised DCT coefficients.

An image is a pure function of (run seed, batch, slot) and of its
configuration: the same arguments give the same coefficients in the
corpus, which encodes them (``harness.jpegenc``), and in the reference,
which decodes them (``references``). The seed draws content only; the
configuration fixes every size and the statistics of the content, so
every seed gives the same shapes and close to the same bits per pixel.

Content, per plane: a smooth field (random values on a coarse grid,
bilinearly interpolated), posterised in part into hard edges, plus
texture at 1/8 scale and per-pixel grain. The configuration's
``content`` sets the amplitudes; chroma planes take them scaled by
``chroma_scale``.
"""

from __future__ import annotations

import numpy as np

from . import jpegenc

# 4:2:0: component (h, v) sampling factors.
SAMPLING = {"420": [(2, 2), (1, 1), (1, 1)]}


def _upsample(grid: np.ndarray, f: int, h: int, w: int) -> np.ndarray:
    """Bilinear interpolation of ``grid`` by the integer factor ``f``,
    cut to (h, w)."""
    t = (np.arange(f, dtype=np.float32) + 0.5) / f
    rows = (grid[:-1, None, :] * (1 - t)[None, :, None]
            + grid[1:, None, :] * t[None, :, None])
    rows = rows.reshape(-1, grid.shape[1])[:h]
    out = (rows[:, :-1, None] * (1 - t)[None, None, :]
           + rows[:, 1:, None] * t[None, None, :])
    return out.reshape(rows.shape[0], -1)[:, :w]


def _plane(rng, h: int, w: int, c: dict, scale: float, mean: float):
    """One photo-like plane, float32, before rounding. The smooth field,
    its posterised edges and the texture are summed at 1/8 scale and
    interpolated once; the grain is drawn at full scale."""
    f = int(c["smooth_cell"]) // 8
    h8, w8 = h // 8 + 2, w // 8 + 2
    smooth = _upsample(rng.uniform(-1, 1, (h8 // f + 2, w8 // f + 2)).astype(
        np.float32), f, h8, w8)
    low = (smooth * c["smooth_amp"]
           + np.floor(smooth * c["edge_levels"]) * c["edge_step"]
           + rng.standard_normal((h8, w8), np.float32) * c["texture_amp"])
    grain = np.frombuffer(rng.bytes(h * w), np.uint8).reshape(h, w)
    p = _upsample(low * np.float32(scale) + np.float32(
        mean - 127.5 * c["grain_amp"] * scale), 8, h, w)
    p += grain * np.float32(c["grain_amp"] * scale)
    return p


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    m = np.sqrt(2 / 8) * np.cos((2 * n + 1) * k * np.pi / 16)
    m[0] /= np.sqrt(2)
    return m.astype(np.float32)


_DCT = _dct_matrix()


def _blocks(plane: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """(bh, bw, 64) natural-order 8x8 blocks of ``plane``, its edges
    replicated out to bh x bw blocks (as libjpeg pads)."""
    h, w = plane.shape
    p = np.pad(plane, ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge")
    return p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(bh, bw, 64)


def _fdct_quant(samples: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Orthonormal 8x8 DCT of (..., 64) level-shifted samples, divided by
    the natural-order table ``q`` and rounded: (..., 64) int16."""
    x = samples.reshape(-1, 8, 8) - np.float32(128)
    y = (x.reshape(-1, 8) @ _DCT.T).reshape(-1, 8, 8)
    y = (y.transpose(0, 2, 1).reshape(-1, 8) @ _DCT.T).reshape(-1, 8, 8)
    d = y.transpose(0, 2, 1).reshape(samples.shape)
    return np.rint(d / q.astype(np.float32)).astype(np.int16)


def image_rng(seed: int, batch: int, slot: int) -> np.random.Generator:
    """The generator of one image: any whole-number seed, large ones too."""
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) & (2 ** 64 - 1), int(batch), int(slot)]))


def tables(quality: int) -> list:
    """The natural-order quantisation tables (luma, chroma)."""
    return [jpegenc.quant_table(jpegenc.LUMA_Q, quality),
            jpegenc.quant_table(jpegenc.CHROMA_Q, quality)]


def geometry(width: int, height: int, subsampling: str = "420") -> dict:
    """Block grid of an image: MCUs across and down, and each component's
    (blocks down, blocks across) as the MCU grid pads them."""
    samp = SAMPLING[subsampling]
    hmax = max(h for h, _ in samp)
    vmax = max(v for _, v in samp)
    mw = -(-width // (8 * hmax))
    mh = -(-height // (8 * vmax))
    comps = [(mh * v, mw * h) for h, v in samp]
    return {"mcus_w": mw, "mcus_h": mh, "blocks": comps, "sampling": samp}


def coefficients(cfg: dict, seed: int, batch: int, slot: int,
                 width: int, height: int) -> list:
    """The quantised coefficients of one image: per component a
    (blocks down, blocks across, 64) int16 natural-order array."""
    rng = image_rng(seed, batch, slot)
    c = cfg["content"]
    g = geometry(width, height, cfg["subsampling"])
    qt = tables(cfg["quality"])
    out = []
    for ci, ((bh, bw), (h, v)) in enumerate(zip(g["blocks"], g["sampling"])):
        hmax = max(s[0] for s in g["sampling"])
        vmax = max(s[1] for s in g["sampling"])
        pw = -(-width * h // hmax)
        ph = -(-height * v // vmax)
        scale = 1.0 if ci == 0 else c["chroma_scale"]
        mean = c["luma_mean"] if ci == 0 else 128.0
        plane = np.clip(np.rint(_plane(rng, ph, pw, c, scale, mean)), 0, 255)
        out.append(_fdct_quant(_blocks(plane.astype(np.float32), bh, bw),
                               qt[min(ci, 1)]))
    return out


def encode(cfg: dict, seed: int, batch: int, slots, width: int,
           height: int, restart_mcus: int = 0) -> list:
    """The JPEG files of images ``slots`` of ``batch``, all of one shape,
    entropy-coded together."""
    g = geometry(width, height, cfg["subsampling"])
    mw, mh = g["mcus_w"], g["mcus_h"]
    comp, chroma = [], []
    for ci, (h, v) in enumerate(g["sampling"]):
        comp += [ci] * (v * h)
        chroma += [ci > 0] * (v * h)
    per_mcu = len(comp)
    images = []
    for slot in slots:
        coefs = coefficients(cfg, seed, batch, slot, width, height)
        parts = []
        for (h, v), co in zip(g["sampling"], coefs):
            zz = co[..., jpegenc.ZIGZAG]
            # (mh, v, mw, h, 64) -> MCU-major, then each component's
            # blocks in raster order inside the MCU.
            zz = zz.reshape(mh, v, mw, h, 64).transpose(0, 2, 1, 3, 4)
            parts.append(zz.reshape(mh * mw, v * h, 64))
        images.append(np.concatenate(parts, axis=1).reshape(-1, 64))
    n = len(images)
    per_image = mh * mw * per_mcu
    scans = jpegenc.encode_scan(
        np.concatenate(images), np.tile(np.array(comp), mh * mw * n),
        np.tile(np.repeat(np.arange(mh * mw), per_mcu), n),
        np.tile(np.array(chroma), mh * mw * n), restart_mcus,
        np.repeat(np.arange(n), per_image))
    qt = tables(cfg["quality"])
    return [jpegenc.write_jpeg(width, height, g["sampling"], qt, scan,
                               restart_mcus) for scan in scans]
