"""The port's YUV -> RGB over every (Y, U, V) triple: the counterpart of
``tests/test_color_exhaustive.py``.

The port's converter (``ops/color.yuv_to_rgb``) gives the JAX package's
converter's bytes on all 2^24 triples, and keeps its contract with the
reference's real-valued BT.709 formula (hip_kernels.cpp:76-78): R and B
exact against round-half-up, G within 1 LSB, off on 6,084 triples. K3's
source, compiled for the host as ``tests/test_torch_epilogue.py`` does,
renders the sweep (``testing/color_sweep.py``: every triple once, as
4:4:4 and as 4:2:0 with every (U, V) pair under every Y) to the JAX
converter's bytes in packed and planar RGB. ``chip_smoke.py``'s
``[color]`` phase runs the same sweep through K3 on the card.
"""

import numpy as np
import pytest
import torch

from rocjpeg_tpu.ops import color as jcolor
from rocjpeg_tpu_torch.kernels import epilogue
from rocjpeg_tpu_torch.ops import color
from rocjpeg_tpu_torch.testing import color_sweep
from rocjpeg_tpu_torch.types import ChromaSubsampling, OutputFormat
from test_torch_epilogue import _kernel_route, compile_host_kernels

CSS = {"444": ChromaSubsampling.CSS_444, "420": ChromaSubsampling.CSS_420}
F = OutputFormat


def _clip8(x):
    return np.clip(x, 0, 255).astype(np.uint8)


def _slabs():
    """All 2^24 triples as 16 slabs of 16 Y values x 256 U x 256 V."""
    u = np.arange(256, dtype=np.int64)[:, None]
    v = np.arange(256, dtype=np.int64)[None, :]
    for y0 in range(0, 256, 16):
        ys = np.arange(y0, y0 + 16, dtype=np.int64)[:, None, None]
        yield (ys, u, v, np.broadcast_to(ys, (16, 256, 256)).astype(np.uint8),
               np.broadcast_to(u[None], (16, 256, 256)).astype(np.uint8),
               np.broadcast_to(v[None], (16, 256, 256)).astype(np.uint8))


def test_converter_matches_the_jax_converter_on_every_triple():
    differing = 0
    for _ys, _u, _v, y8, u8, v8 in _slabs():
        ours = color.yuv_to_rgb(*(torch.from_numpy(p) for p in (y8, u8, v8)))
        theirs = jcolor.yuv_to_rgb(np, y8, u8, v8)
        for a, b in zip(ours, theirs):
            differing += int((a.numpy() != b).sum())
    assert differing == 0


def test_r_and_b_channels_exhaustive():
    y = np.arange(256, dtype=np.int64)[:, None]
    c = np.arange(256, dtype=np.int64)[None, :]  # U for B, V for R
    c8 = torch.from_numpy(np.broadcast_to(c, (256, 256)).astype(np.uint8))
    y8 = torch.from_numpy(np.broadcast_to(y, (256, 256)).astype(np.uint8))
    mid = torch.full_like(c8, 128)
    r, _, _ = color.yuv_to_rgb(y8, mid, c8)
    _, _, b = color.yuv_to_rgb(y8, c8, mid)
    # Round-half-up of the real-valued formula: exact everywhere.
    np.testing.assert_array_equal(
        r.numpy(), _clip8(np.floor(y + 1.5748 * (c - 128) + 0.5)))
    np.testing.assert_array_equal(
        b.numpy(), _clip8(np.floor(y + 1.8556 * (c - 128) + 0.5)))
    # Round-to-nearest-even (the reference GPU's pack) within 1 LSB.
    r_rne = _clip8(np.rint(y + 1.5748 * (c - 128)))
    assert int(np.abs(r.numpy().astype(int) - r_rne.astype(int)).max()) <= 1


def test_g_channel_exhaustive():
    """Off by at most 1 LSB from round-half-up, on the 6,084 of 2^24
    triples that sit at tie points of the two 16-bit constants."""
    mismatches = 0
    for ys, u, v, y8, u8, v8 in _slabs():
        _, g, _ = color.yuv_to_rgb(*(torch.from_numpy(p)
                                     for p in (y8, u8, v8)))
        g_ref = _clip8(np.floor(
            ys - 0.1873 * (u[None] - 128) - 0.4681 * (v[None] - 128) + 0.5))
        diff = np.abs(g.numpy().astype(np.int64) - g_ref.astype(np.int64))
        assert int(diff.max()) <= 1
        mismatches += int((diff > 0).sum())
    assert mismatches == 6084


def _jax_rgb(y, u, v):
    """The JAX converter's (R, G, B) of full-resolution planes, a frame at
    a time."""
    out = [np.empty(y.shape, np.uint8) for _ in range(3)]
    for k in range(y.shape[0]):
        for o, p in zip(out, jcolor.yuv_to_rgb(np, y[k], u[k], v[k])):
            o[k] = p
    return out


@pytest.fixture(scope="module")
def sweeps():
    """{css: (planes, width, height, (R, G, B) of the JAX converter)}."""
    out = {}
    for css in CSS:
        planes, w, h = color_sweep.sweep_planes(css)
        full = [p.numpy() for p in color_sweep.upsampled(css, planes)]
        for p in full[1:]:
            assert p.shape == full[0].shape
        triples = (full[0].astype(np.int32) << 16 | full[1].astype(
            np.int32) << 8 | full[2]).reshape(-1)
        assert np.array_equal(np.sort(triples), np.arange(1 << 24))
        out[css] = (planes, w, h, _jax_rgb(*full))
    return out


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    return compile_host_kernels(tmp_path_factory.mktemp("color_host"),
                                {"default": ()})["default"]


CASES = [(css, fmt) for css in CSS for fmt in (F.RGB, F.RGB_PLANAR)]


@pytest.mark.parametrize("css,fmt", CASES,
                         ids=[f"{c}-{f.name}" for c, f in CASES])
def test_kernel_source_matches_the_jax_converter_on_every_triple(
        sweeps, host_kernel, monkeypatch, css, fmt):
    monkeypatch.setattr(epilogue, "launches", 0)
    planes, w, h, (r, g, b) = sweeps[css]
    got = _kernel_route(host_kernel, CSS[css], planes, w, h, fmt, None)
    if fmt == F.RGB:
        (rgb, pitch), = got
        assert pitch == 3 * w
        rgb = rgb.numpy().reshape(r.shape + (3,))
        differing = sum(int((rgb[..., c] != want).sum())
                        for c, want in enumerate((r, g, b)))
    else:
        assert [p for _, p in got] == [w] * 3
        differing = sum(int((ch.numpy() != want).sum())
                        for (ch, _), want in zip(got, (r, g, b)))
    assert differing == 0
    assert epilogue.launches >= 1
