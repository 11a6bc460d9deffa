"""The port's decoder on streams that another encoder makes: libjpeg,
through PIL, at test time. The port's counterpart of
``tests/test_golden.py``'s libjpeg checks.

Every stream goes through the port's CPU ``Decoder`` and the JAX package's
``Decoder``: the same bytes and pitches in every output format, or the same
``Status`` where they refuse it (progressive, CMYK, a frame below the
spec's minimum). The cases cover 4:4:4, 4:2:2, 4:2:0 and grayscale,
libjpeg's standard and optimized Huffman tables, quality 50 and 95, DRI=0
and restart markers every 1 or 3 MCUs or every MCU row, sizes that are not
a multiple of the MCU, and batches of 1024x768 frames large enough for the
``'wave'`` and ``'wave-virtual'`` paths. The port's luma must also equal
libjpeg's own (draft-mode YCbCr, which neither upsamples nor converts), and
at 4:4:4 all three planes must. Tolerance 0 throughout.
"""

import functools
import io

import numpy as np
import pytest
import torch

from rocjpeg_tpu import api as japi
from rocjpeg_tpu import status as jstatus
from rocjpeg_tpu import types as jtypes
from rocjpeg_tpu_torch import api
from rocjpeg_tpu_torch.status import RocJpegError
from rocjpeg_tpu_torch.testing import encoder
from rocjpeg_tpu_torch.types import DecodeParams, OutputFormat
from test_torch_jaxlib import jax_native  # noqa: F401  (autouse)

Image = pytest.importorskip("PIL.Image")

F = OutputFormat
SUBSAMPLING = {"444": 0, "422": 1, "420": 2}  # PIL's codes; "gray": mode L
RESTARTS = {"dri0": {}, "blocks1": {"restart_marker_blocks": 1},
            "blocks3": {"restart_marker_blocks": 3},
            "rows1": {"restart_marker_rows": 1}}
SMALL = (130, 77)  # neither a multiple of 8 nor of 16
LARGE = (1024, 768)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _libjpeg(css, w, h, seed, quality=90, optimize=False, restart="dri0",
             mode=None, progressive=False):
    """A stream libjpeg encodes from photo-like RGB content of ``w`` x
    ``h`` (``mode``: convert to "CMYK" first)."""
    planes = encoder.photo_planes("444", w, h, seed=seed)
    im = Image.fromarray(np.stack(planes, axis=-1), "YCbCr").convert("RGB")
    kw = dict(quality=quality, optimize=optimize, progressive=progressive,
              **RESTARTS[restart])
    if css == "gray":
        im = im.convert("L")
    elif mode:
        im = im.convert(mode)
    else:
        kw["subsampling"] = SUBSAMPLING[css]
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _libjpeg_planes(blob):
    """libjpeg's own decode, before upsampling and colour conversion:
    (H, W, components) uint8."""
    im = Image.open(io.BytesIO(blob))
    if im.mode == "L":
        return np.asarray(im)[..., None]
    im.draft("YCbCr", im.size)
    return np.asarray(im)


@functools.lru_cache(maxsize=None)
def _decoders(entropy):
    return (japi.Decoder(device_entropy=entropy),
            api.Decoder(device="cpu", device_entropy=entropy))


def _jax_outcome(dec, blobs, fmt):
    """The JAX package's ([(channels as numpy, pitches)], paths), or the
    name of the Status it raised."""
    try:
        imgs = dec.decode_batched([japi.JpegStream(b) for b in blobs],
                                  jtypes.DecodeParams(jtypes.OutputFormat(
                                      int(fmt))))
    except jstatus.RocJpegError as exc:
        return exc.status.name
    return ([([None if c is None else np.asarray(c) for c in img.channel],
              list(img.pitch)) for img in imgs],
            [(p, list(i)) for p, i in dec.last_paths])


def _port_outcome(dec, blobs, fmt):
    try:
        imgs = dec.decode_batched([api.JpegStream(b) for b in blobs],
                                  DecodeParams(fmt))
    except RocJpegError as exc:
        return exc.status.name
    return ([([None if c is None else c.numpy() for c in img.channel],
              list(img.pitch)) for img in imgs],
            [(p, list(i)) for p, i in dec.last_paths])


def _same(blobs, fmt, entropy="auto"):
    """Decode ``blobs`` in both packages; assert the same outcome. Returns
    the port's outcome."""
    jdec, tdec = _decoders(entropy)
    want = _jax_outcome(jdec, blobs, fmt)
    got = _port_outcome(tdec, blobs, fmt)
    if isinstance(want, str) or isinstance(got, str):
        assert got == want
        return got
    assert got[1] == want[1]  # paths and their images
    for (gc, gp), (wc, wp) in zip(got[0], want[0], strict=True):
        assert gp == wp
        for ci, (a, b) in enumerate(zip(gc, wc, strict=True)):
            if b is None:
                assert a is None, ci
                continue
            assert a.dtype == b.dtype and a.shape == b.shape, ci
            np.testing.assert_array_equal(a, b, err_msg=f"channel {ci}")
    return got


def _assert_luma_is_libjpegs(blob, images):
    """The port's Y format output of ``blob`` against libjpeg's luma."""
    ref = _libjpeg_planes(blob)[:, :, 0]
    for chans, pitches in images:
        assert pitches[0] == ref.shape[1]
        np.testing.assert_array_equal(chans[0].reshape(ref.shape), ref)


@pytest.mark.parametrize("restart", list(RESTARTS))
@pytest.mark.parametrize("optimize", [False, True],
                         ids=["standard", "optimized"])
@pytest.mark.parametrize("css", ["444", "422", "420", "gray"])
def test_small_stream_matches_jax_and_libjpeg(css, optimize, restart):
    """Every output format byte-equal to the JAX package's (the host
    entropy path at this size), luma equal to libjpeg's."""
    quality = 95 if optimize == (restart in ("dri0", "blocks3")) else 50
    blob = _libjpeg(css, *SMALL, seed=len(css) + 5 * len(restart),
                    quality=quality, optimize=optimize, restart=restart)
    for fmt in F:
        _same([blob], fmt)
    _assert_luma_is_libjpegs(blob, _same([blob], F.Y)[0])
    if css == "444":
        ref = _libjpeg_planes(blob)
        (chans, _pitches), = _same([blob], F.YUV_PLANAR)[0]
        for i in range(3):
            np.testing.assert_array_equal(
                chans[i].reshape(ref.shape[:2]), ref[:, :, i])


@pytest.mark.parametrize("css,restart,path", [
    ("420", "dri0", "wave-virtual"), ("420", "blocks1", "wave"),
    ("422", "blocks3", "wave"), ("444", "dri0", "wave-virtual"),
])
def test_large_batch_matches_jax_and_libjpeg(css, restart, path):
    """Batches of 4 different 1024x768 frames on the device-entropy paths
    (the kernels' plain versions here): the JAX package's bytes, libjpeg's
    luma."""
    blobs = [_libjpeg(css, *LARGE, seed=s, quality=(50, 95)[s % 2],
                      optimize=bool(s % 2), restart=restart)
             for s in range(4)]
    got = _same(blobs, F.NATIVE)
    assert got[1] == [(path, [0, 1, 2, 3])]
    images = _same(blobs, F.Y)[0]
    for blob, image in zip(blobs, images):
        _assert_luma_is_libjpegs(blob, [image])


@pytest.mark.parametrize("case", ["progressive", "cmyk", "below_minimum"])
def test_refused_stream_matches_jax(case):
    """What both packages refuse, they refuse with the same Status."""
    if case == "progressive":
        blob = _libjpeg("420", *SMALL, seed=1, progressive=True)
    elif case == "cmyk":
        blob = _libjpeg("444", *SMALL, seed=2, mode="CMYK")
    else:
        blob = _libjpeg("420", 17, 9, seed=3)
    for fmt in (F.NATIVE, F.RGB):
        assert isinstance(_same([blob], fmt), str)
