"""Plane assembly, chroma upsampling and native surface layouts, in PyTorch.

Port of ``rocjpeg_tpu/ops/layout.py``: NATIVE layouts per subsampling
(444 -> three planes, 440 -> three planes with half-height chroma,
422 -> packed YUYV, 420 -> Y + interleaved UV (NV12), 400 -> Y), and
nearest-neighbour chroma upsampling. Every function works on a leading
batch axis.
"""

from __future__ import annotations

import torch


def blocks_to_plane(blocks):
    """(..., bh, bw, 8, 8) spatial blocks -> (..., bh*8, bw*8) plane."""
    s = blocks.shape
    bh, bw = s[-4], s[-3]
    return blocks.transpose(-3, -2).reshape(s[:-4] + (bh * 8, bw * 8))


def upsample_to_luma(plane, h_factor: int, v_factor: int):
    """Nearest-neighbour upsample by integer factors."""
    out = plane
    if v_factor > 1:
        out = torch.repeat_interleave(out, v_factor, dim=-2)
    if h_factor > 1:
        out = torch.repeat_interleave(out, h_factor, dim=-1)
    return out


def pack_yuyv(y, u, v):
    """(..., H, W) luma + (..., H, W/2) chroma -> (..., H, 2W) packed YUYV
    (Y0 U0 Y1 V0)."""
    h, w = y.shape[-2], y.shape[-1]
    pairs = w // 2
    y_pairs = y.reshape(y.shape[:-1] + (pairs, 2))
    quad = torch.stack([y_pairs[..., 0], u[..., :pairs], y_pairs[..., 1],
                        v[..., :pairs]], dim=-1)
    return quad.reshape(y.shape[:-2] + (h, w * 2))


def interleave_uv(u, v):
    """(..., H, W) U + V -> (..., H, 2W) interleaved UV (NV12 second plane)."""
    h, w = u.shape[-2], u.shape[-1]
    return torch.stack([u, v], dim=-1).reshape(u.shape[:-2] + (h, 2 * w))


def interleave_rgb(r, g, b):
    """Three (..., H, W) planes -> (..., H, 3W) packed interleaved RGB."""
    h, w = r.shape[-2], r.shape[-1]
    return torch.stack([r, g, b], dim=-1).reshape(r.shape[:-2] + (h, 3 * w))
