"""Dequantization + 8x8 inverse DCT, exact int32 fixed point, in PyTorch.

Port of ``rocjpeg_tpu/ops/idct.py`` ``dequant_idct_8x8``: the same int32
expression graph (the Loeffler-Ligtenberg-Moshovitz islow IDCT with 13-bit
constants and PASS1_BITS = 2), so results are bit-identical to the numpy
and XLA versions, wraparound included. int32 products that overflow wrap
two's-complement in torch, as in numpy and XLA.
"""

from __future__ import annotations

import torch

CONST_BITS = 13
PASS1_BITS = 2

# round(c * 2**13) for the Loeffler rotation constants.
FIX_0_298631336 = 2446
FIX_0_390180644 = 3196
FIX_0_541196100 = 4433
FIX_0_765366865 = 6270
FIX_0_899976223 = 7373
FIX_1_175875602 = 9633
FIX_1_501321110 = 12299
FIX_1_847759065 = 15137
FIX_1_961570560 = 16069
FIX_2_053119869 = 16819
FIX_2_562915447 = 20995
FIX_3_072711026 = 25172


def _descale(x, n: int):
    """Round-to-nearest arithmetic right shift: (x + 2^(n-1)) >> n."""
    return (x + (1 << (n - 1))) >> n


def _idct8(inp, first_pass: bool):
    """One 8-point 1-D IDCT over a list of eight int32 tensors (frequency
    indices 0..7); returns the eight spatial-sample tensors."""
    z2, z3 = inp[2], inp[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * (-FIX_1_847759065)
    tmp3 = z1 + z2 * FIX_0_765366865
    z2, z3 = inp[0], inp[4]
    tmp0 = (z2 + z3) << CONST_BITS
    tmp1 = (z2 - z3) << CONST_BITS
    tmp10 = tmp0 + tmp3
    tmp13 = tmp0 - tmp3
    tmp11 = tmp1 + tmp2
    tmp12 = tmp1 - tmp2

    t0, t1, t2, t3 = inp[7], inp[5], inp[3], inp[1]
    z1 = t0 + t3
    z2 = t1 + t2
    z3 = t0 + t2
    z4 = t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * (-FIX_0_899976223)
    z2 = z2 * (-FIX_2_562915447)
    z3 = z3 * (-FIX_1_961570560) + z5
    z4 = z4 * (-FIX_0_390180644) + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4

    shift = ((CONST_BITS - PASS1_BITS) if first_pass
             else (CONST_BITS + PASS1_BITS + 3))
    return [_descale(tmp10 + t3, shift), _descale(tmp11 + t2, shift),
            _descale(tmp12 + t1, shift), _descale(tmp13 + t0, shift),
            _descale(tmp13 - t0, shift), _descale(tmp12 - t1, shift),
            _descale(tmp11 - t2, shift), _descale(tmp10 - t3, shift)]


def dequant_idct_8x8(coeffs, quant):
    """Dequantize + 2-D IDCT + level shift + clamp.

    coeffs: (..., 8, 8) integer natural-order coefficients;
    quant: broadcastable (..., 8, 8) natural-order quant table.
    Returns (..., 8, 8) uint8 samples."""
    x = coeffs.to(torch.int32) * quant.to(torch.int32)
    cols = _idct8([x[..., i, :] for i in range(8)], first_pass=True)
    y = torch.stack(cols, dim=-2)
    rows = _idct8([y[..., :, i] for i in range(8)], first_pass=False)
    out = torch.stack(rows, dim=-1)
    return torch.clamp(out + 128, 0, 255).to(torch.uint8)
