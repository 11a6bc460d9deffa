"""YUV -> RGB, full-range BT.709, exact 16-bit fixed point, in PyTorch.

Port of ``rocjpeg_tpu/ops/color.py`` ``yuv_to_rgb`` with the same int32
arithmetic and round-half-up, so results are bit-identical to it.
"""

from __future__ import annotations

import torch

FIX_BITS = 16
FIX_ROUND = 1 << (FIX_BITS - 1)

# R = Y + 1.5748 (V-128); G = Y - 0.1873 (U-128) - 0.4681 (V-128);
# B = Y + 1.8556 (U-128), in 16-bit fixed point.
CR_V = round(1.5748 * (1 << FIX_BITS))  # 103206
CG_U = round(-0.1873 * (1 << FIX_BITS))  # -12275
CG_V = round(-0.4681 * (1 << FIX_BITS))  # -30677
CB_U = round(1.8556 * (1 << FIX_BITS))  # 121609


def yuv_to_rgb(y, u, v):
    """Full-resolution Y/U/V uint8 planes -> (R, G, B) uint8 planes (chroma
    already upsampled to luma size)."""
    yi = y.to(torch.int32) << FIX_BITS
    ui = u.to(torch.int32) - 128
    vi = v.to(torch.int32) - 128
    r = (yi + CR_V * vi + FIX_ROUND) >> FIX_BITS
    g = (yi + CG_U * ui + CG_V * vi + FIX_ROUND) >> FIX_BITS
    b = (yi + CB_U * ui + FIX_ROUND) >> FIX_BITS

    def clip(t):
        return torch.clamp(t, 0, 255).to(torch.uint8)

    return clip(r), clip(g), clip(b)
