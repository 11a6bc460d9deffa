"""Planes that hold every (Y, U, V) triple of 8-bit samples once, for the
exhaustive checks of the colour conversion (the tests on the CPU,
``chip_smoke.py``'s ``[color]`` phase on the card).
"""

from __future__ import annotations

import torch

# 4:4:4: one 4096 x 4096 frame, sample i of the frame holding
# (i >> 16, (i >> 8) & 255, i & 255).
SIDE_444 = 4096
# 4:2:0: 64 frames of 512 x 512, frame k's chroma sample (i, j) holding
# (U, V) = (i, j) over the four luma samples 4k, 4k + 1, 4k + 2, 4k + 3.
FRAMES_420, SIDE_420 = 64, 512


def sweep_planes(css: str, device="cpu") -> tuple:
    """``((y, u, v), width, height)`` of the sweep for ``css`` ("444" or
    "420"): uint8 planes of shape (batch, rows, columns) on ``device``,
    every (Y, U, V) triple once, each chroma sample under its luma samples
    as the decoder's nearest upsampling places it."""
    u8 = torch.uint8
    if css == "444":
        i = torch.arange(1 << 24, dtype=torch.int32, device=device).view(
            1, SIDE_444, SIDE_444)
        planes = ((i >> 16).to(u8), ((i >> 8) & 255).to(u8),
                  (i & 255).to(u8))
        return planes, SIDE_444, SIDE_444
    if css == "420":
        n, c = FRAMES_420, SIDE_420 // 2
        ar = torch.arange(256, dtype=torch.int32, device=device)
        k = torch.arange(n, dtype=torch.int32, device=device)
        two = torch.arange(2, dtype=torch.int32, device=device)
        y = (4 * k.view(n, 1, 1, 1, 1) + 2 * two.view(1, 1, 2, 1, 1)
             + two.view(1, 1, 1, 1, 2)).expand(n, c, 2, c, 2)
        planes = (y.reshape(n, SIDE_420, SIDE_420).to(u8),
                  ar.view(1, c, 1).expand(n, c, c).to(u8).contiguous(),
                  ar.view(1, 1, c).expand(n, c, c).to(u8).contiguous())
        return planes, SIDE_420, SIDE_420
    raise ValueError(f"no sweep of subsampling {css!r}")


def upsampled(css: str, planes) -> tuple:
    """The sweep's (y, u, v) at luma resolution, as the epilogue upsamples
    them."""
    y, u, v = planes
    if css == "420":
        u, v = (p.repeat_interleave(2, 1).repeat_interleave(2, 2)
                for p in (u, v))
    return y, u, v
