"""K2 parity: the port's transform against the JAX program and numpy.

Seeded coefficients with extremes (+-32767, quant up to 255, DC fixups that
wrap int16) go through the port's plain transform (``transform`` on CPU
tensors) and through the JAX package's ``_transform_from_flat`` program
(rendered as YUV_PLANAR, which crops to the picture) and
``rocjpeg_tpu.ops.idct.dequant_idct_8x8`` on numpy (full MCU-padded
planes). The tolerance is zero: the reference is int32 fixed point.
"""

import numpy as np
import pytest
import torch

from rocjpeg_tpu import pipeline as jpipeline
from rocjpeg_tpu.core.bitstream import JpegStreamParser
from rocjpeg_tpu.ops import color as jcolor
from rocjpeg_tpu.ops import device_entropy as de
from rocjpeg_tpu.ops import idct as jidct
from rocjpeg_tpu.ops import layout as jlayout
from rocjpeg_tpu.types import OutputFormat as JaxOutputFormat
from rocjpeg_tpu_torch import convert
from rocjpeg_tpu_torch.kernels import transform
from rocjpeg_tpu_torch.ops import color, idct, postprocess, tables
from rocjpeg_tpu_torch.status import RocJpegError, Status
from rocjpeg_tpu_torch.testing import encoder
from rocjpeg_tpu_torch.types import OutputFormat


def _extreme_coeffs(rng, n):
    c = rng.integers(-32768, 32768, n).astype(np.int16)
    c[rng.random(n) < 0.2] = 32767
    c[rng.random(n) < 0.2] = -32767
    c[rng.random(n) < 0.3] = 0
    return c


def _group(css, w=40, h=24, batch=2, seed=0):
    blob = encoder.encode_planes(encoder.random_planes(css, w, h, seed=seed),
                                 css, restart_interval=1)
    p = JpegStreamParser().parse(blob)
    rng = np.random.default_rng(seed)
    geom = tables.GroupGeometry.from_params(convert.params_from_jax(p),
                                            batch)
    coeffs = _extreme_coeffs(rng, batch * geom.total_blocks * 64)
    quant = rng.integers(1, 256, (batch, 3, 64)).astype(np.int32)
    n_lanes = 7
    dc_flat = rng.integers(-2 ** 31, 2 ** 31, (n_lanes, 3)).astype(np.int32)
    total_mcus = (p.num_mcus if len(p.scan_components) > 1
                  else geom.comp_dims()[0][0] * geom.comp_dims()[0][1])
    lane_of_mcu = rng.integers(0, n_lanes, (batch, total_mcus)).astype(np.int32)
    return p, geom, coeffs, quant, dc_flat, lane_of_mcu


def _numpy_planes(geom, coeffs, quant, dc_flat, lane_of_mcu, dc_fix):
    planes = []
    per_img = coeffs.reshape(geom.batch, -1)
    for c, (bh, bw) in enumerate(geom.comp_dims()):
        base = geom.comp_base[c]
        blocks = per_img[:, base * 64:(base + bh * bw) * 64].reshape(
            geom.batch, bh, bw, 64).copy()
        if dc_fix:
            s = geom.comp_of_slot.index(c)
            hs, vs = geom.col_step[s], geom.row_step[s] // bw
            by, bx = np.mgrid[0:bh, 0:bw]
            lanes = lane_of_mcu[:, (by // vs) * geom.mcus_w + bx // hs]
            blocks[..., 0] += dc_flat[lanes, c].astype(np.int16)
        samples = jidct.dequant_idct_8x8(
            np, blocks.reshape(geom.batch, bh, bw, 8, 8),
            quant[:, c].reshape(geom.batch, 1, 1, 8, 8))
        planes.append(jlayout.blocks_to_plane(np, samples))
    return planes


@pytest.mark.parametrize("dc_fix", [False, True], ids=["plain", "dcfix"])
@pytest.mark.parametrize("css", ["444", "440", "422", "420", "400"])
def test_transform_matches_jax_and_numpy(css, dc_fix):
    p, geom, coeffs, quant, dc_flat, lom = _group(css)
    fix = ((torch.from_numpy(dc_flat), torch.from_numpy(lom)) if dc_fix
           else ())
    planes = transform.transform(torch.from_numpy(coeffs),
                                 torch.from_numpy(quant), geom, *fix)
    ref = _numpy_planes(geom, coeffs, quant, dc_flat, lom, dc_fix)
    assert len(planes) == len(ref)
    for got, want in zip(planes, ref):
        np.testing.assert_array_equal(got.numpy(), want)

    jgeom = de.GroupGeometry.from_params(p, geom.batch)
    fn = jpipeline._transform_from_flat(
        jgeom, p.chroma_subsampling, p.picture_width, p.picture_height,
        JaxOutputFormat.YUV_PLANAR, None, dc_fix)
    jfix = (dc_flat, lom) if dc_fix else ()
    outs = fn(coeffs, quant[:, 0], quant[:, 1], quant[:, 2], *jfix)
    y = planes[0]
    u, v = (planes[1], planes[2]) if len(planes) == 3 else (None, None)
    mine = postprocess.render_output(p.chroma_subsampling, (y, u, v),
                                     p.picture_width, p.picture_height,
                                     OutputFormat.YUV_PLANAR)
    assert len(mine) == len(outs)
    for (got, _pitch), want in zip(mine, outs):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_transform_host_plane_layout():
    """with_planes: a geometry over the host decoder's plane dims."""
    _, geom, coeffs, quant, _, _ = _group("420")
    dims = geom.comp_dims()
    again = geom.with_planes(dims)
    assert again == geom
    planes = transform.transform(torch.from_numpy(coeffs),
                                 torch.from_numpy(quant), again)
    assert [tuple(t.shape) for t in planes] == [
        (geom.batch, bh * 8, bw * 8) for bh, bw in dims]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_idct_matches_numpy_on_extremes(seed):
    rng = np.random.default_rng(seed)
    c = _extreme_coeffs(rng, 300 * 64).reshape(300, 8, 8)
    q = rng.integers(1, 256, (300, 8, 8)).astype(np.int32)
    got = idct.dequant_idct_8x8(torch.from_numpy(c), torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(),
                                  jidct.dequant_idct_8x8(np, c, q))


def test_yuv_to_rgb_matches_numpy():
    rng = np.random.default_rng(3)
    y, u, v = (rng.integers(0, 256, (256, 256)).astype(np.uint8)
               for _ in range(3))
    got = color.yuv_to_rgb(*(torch.from_numpy(a) for a in (y, u, v)))
    for g, w in zip(got, jcolor.yuv_to_rgb(np, y, u, v)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_transform_rejects_bad_inputs():
    _, geom, coeffs, quant, dc_flat, _ = _group("420")
    with pytest.raises(RocJpegError) as ei:
        transform.transform(torch.from_numpy(coeffs[:-64]),
                            torch.from_numpy(quant), geom)
    assert ei.value.status == Status.INVALID_PARAMETER
    with pytest.raises(RocJpegError):
        transform.transform(torch.from_numpy(coeffs), torch.from_numpy(quant),
                            geom, torch.from_numpy(dc_flat), None)

