"""Session-API parity: the port's Decoder against the JAX package's.

``rocjpeg_tpu.api.Decoder`` and ``rocjpeg_tpu_torch.api.Decoder(device=
"cpu")`` decode the same seeded streams (restart and DRI=0, every CSS, all
five output formats, crops, corrupt scans, the host path); channels must
be byte-equal, and the entropy paths, failed indices and Status codes the
same. On CPU the port runs every kernel's plain PyTorch version.
"""

import functools

import numpy as np
import pytest
import torch

from rocjpeg_tpu import api as japi
from rocjpeg_tpu import status as jstatus
from rocjpeg_tpu import types as jtypes
from rocjpeg_tpu_torch import api as tapi
from rocjpeg_tpu_torch import status as tstatus
from rocjpeg_tpu_torch import types as ttypes
from rocjpeg_tpu_torch.status import RocJpegError, Status
from rocjpeg_tpu_torch.testing import encoder
from rocjpeg_tpu_torch.types import CropRectangle, OutputFormat

# Each package takes its own types and raises its own error class; enums
# and statuses are compared by name and value.
SIDES = {japi: (jtypes, jstatus), tapi: (ttypes, tstatus)}


def _params(mod, fmt=OutputFormat.NATIVE, crop=None):
    """DecodeParams of ``mod``'s package for a format and a crop given as
    the port's."""
    types = SIDES[mod][0]
    kwargs = {}
    if crop is not None:
        kwargs["crop_rectangle"] = types.CropRectangle(
            crop.left, crop.top, crop.right, crop.bottom)
    return types.DecodeParams(types.OutputFormat(int(fmt)), **kwargs)


def _status(exc):
    return exc.status.name, int(exc.status)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain kernels step over small tensors: torch's intra-op pool only
    spins there, against the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

F = OutputFormat


def _photo_planes(css, w, h, seed):
    """Photo-like planes: a blocky low-frequency base plus mild noise. Far
    fewer symbols than uniform noise, which keeps both waves' step loops
    (and the JAX compile variants) small."""
    rng = np.random.default_rng(seed)
    hf, vf = {"444": (1, 1), "440": (1, 2), "422": (2, 1), "420": (2, 2),
              "400": (1, 1)}[css]

    def plane(ph, pw):
        base = rng.integers(0, 256, (ph // 8 + 1, pw // 8 + 1))
        up = np.kron(base, np.ones((8, 8)))[:ph, :pw]
        return np.clip(up + rng.normal(0, 6, (ph, pw)), 0, 255).astype(np.uint8)

    planes = [plane(h, w)]
    if css != "400":
        planes += [plane(h // vf, w // hf), plane(h // vf, w // hf)]
    return planes


@functools.lru_cache(maxsize=None)
def _blobs(css, ri, w=64, h=64, n=2):
    return tuple(encoder.encode_planes(
        _photo_planes(css, w, h, seed=10 * s + ri), css,
        restart_interval=ri) for s in range(n))


@pytest.fixture(scope="module")
def decoders():
    return {mode: (japi.Decoder(device_entropy=mode),
                   tapi.Decoder(device="cpu", device_entropy=mode))
            for mode in ("on", "off")}


def _both(decoders, blobs, fmt, crop=None, mode="on"):
    jdec, tdec = decoders[mode]
    out = [dec.decode_batched([mod.JpegStream(b) for b in blobs],
                              _params(mod, fmt, crop))
           for mod, dec in ((japi, jdec), (tapi, tdec))]
    assert ([p for p, _ in jdec.last_paths]
            == [p for p, _ in tdec.last_paths])
    assert len(jdec.last_error_flags) == len(tdec.last_error_flags)
    return out, jdec, tdec


def _assert_same_images(a_imgs, b_imgs):
    assert len(a_imgs) == len(b_imgs)
    for a, b in zip(a_imgs, b_imgs):
        assert a.pitch == b.pitch
        for ca, cb in zip(a.channel, b.channel):
            assert (ca is None) == (cb is None)
            if ca is not None:
                np.testing.assert_array_equal(np.asarray(ca), cb.numpy())


CASES = ([(css, f, 2) for css in ("420", "422") for f in F]
         + [(css, f, 0) for css in ("420", "422") for f in (F.NATIVE, F.RGB)]
         + [(css, f, ri) for css in ("444", "440", "400")
            for f, ri in ((F.NATIVE, 2), (F.RGB, 2), (F.NATIVE, 0))])


@pytest.mark.parametrize("css,fmt,ri", CASES,
                         ids=[f"{c}-{f.name}-ri{r}" for c, f, r in CASES])
def test_decode_matches_jax(decoders, css, fmt, ri):
    (a, b), jdec, _ = _both(decoders, _blobs(css, ri), fmt)
    assert jdec.last_paths[0][0] == ("wave" if ri else "wave-virtual")
    _assert_same_images(a, b)


@pytest.mark.parametrize("ri", [1, 0])
@pytest.mark.parametrize("crop", [CropRectangle(8, 18, 60, 50),
                                  CropRectangle(40, 10, 20, 50)],
                         ids=["valid", "invalid"])
def test_crop_odd_size_matches_jax(decoders, crop, ri):
    blobs = _blobs("420", ri, w=72, h=66)
    (a, b), _, _ = _both(decoders, blobs, F.RGB, crop)
    _assert_same_images(a, b)


@pytest.mark.parametrize("css,fmt", [("420", F.NATIVE), ("400", F.Y)])
def test_host_path_matches_jax(decoders, css, fmt):
    (a, b), jdec, _ = _both(decoders, _blobs(css, 2), fmt, mode="off")
    assert [p for p, _ in jdec.last_paths] == ["host"]
    _assert_same_images(a, b)


def _corrupt(stream):
    """Garbage the middle of a scan, keeping its restart markers."""
    bad = bytearray(stream.params.slice_data)
    for i in range(32, 64):
        bad[i] = 0xFF if i % 2 else 0xD9
    stream.params.slice_data = bytes(bad)


def test_corrupt_restart_scan_same_error(decoders):
    blobs = _blobs("420", 4, w=128, h=96, n=4)
    errors = []
    for mod, dec in ((japi, decoders["on"][0]), (tapi, decoders["on"][1])):
        streams = [mod.JpegStream(b) for b in blobs]
        _corrupt(streams[2])
        with pytest.raises(SIDES[mod][1].RocJpegError) as ei:
            dec.decode_batched(streams, _params(mod, F.Y))
        errors.append((_status(ei.value), dec.last_failed_indices(),
                       [p for p, _ in dec.last_paths]))
    assert errors[0] == errors[1]
    assert errors[0][0] == ("BAD_JPEG", -3) and errors[0][1] == [2]


def test_corrupt_dri0_scan_falls_back_and_raises(decoders):
    """A DRI=0 stream the index walk rejects falls back to the host path,
    which raises BAD_JPEG."""
    blobs = _blobs("420", 0, w=96, h=64, n=1)
    errors = []
    for mod, dec in ((japi, decoders["on"][0]), (tapi, decoders["on"][1])):
        stream = mod.JpegStream(blobs[0])
        stream.params.slice_data = stream.params.slice_data[
            :len(stream.params.slice_data) // 3]
        with pytest.raises(SIDES[mod][1].RocJpegError) as ei:
            dec.decode(stream, _params(mod, F.Y))
        errors.append(_status(ei.value))
    assert errors == [("BAD_JPEG", -3), ("BAD_JPEG", -3)]


def test_lazy_failed_indices_match_jax():
    blobs = _blobs("420", 4, w=128, h=96, n=4)
    got = []
    for mod, dec in ((japi, japi.Decoder(device_entropy="on",
                                         check_errors=False)),
                     (tapi, tapi.Decoder(device="cpu", device_entropy="on",
                                         check_errors=False))):
        streams = [mod.JpegStream(b) for b in blobs]
        _corrupt(streams[1])
        _corrupt(streams[3])
        assert len(dec.decode_batched(streams, _params(mod, F.Y))) == 4
        got.append(dec.last_failed_indices())
    assert got[0] == got[1] == [1, 3]


@pytest.mark.parametrize("css", ["444", "440", "422", "420", "400"])
def test_image_info_matches_jax(decoders, css):
    blob = _blobs(css, 2, w=72, h=66, n=1)[0]
    a = decoders["on"][0].get_image_info(japi.JpegStream(blob))
    b = decoders["on"][1].get_image_info(tapi.JpegStream(blob))
    assert (a.num_components, int(a.subsampling), a.subsampling.name,
            a.widths, a.heights) == (
        b.num_components, int(b.subsampling), b.subsampling.name,
        b.widths, b.heights)


def test_unsupported_resolution_same_status(decoders):
    blob = encoder.encode_planes(encoder.random_planes("420", 48, 64), "420")
    for mod, dec in ((japi, decoders["on"][0]), (tapi, decoders["on"][1])):
        with pytest.raises(SIDES[mod][1].RocJpegError) as ei:
            dec.decode(mod.JpegStream(blob))
        assert _status(ei.value) == ("JPEG_NOT_SUPPORTED", -4)


def test_past_four_table_banks_falls_back_to_host(decoders):
    """Five distinct Huffman table sets in one group: the packer refuses
    (JPEG_NOT_SUPPORTED) and both decoders take the host path."""
    blobs = [encoder.encode_planes(_photo_planes("400", 64, 64, seed=s),
                                   "400", optimize=True) for s in range(5)]
    out, jdec, _ = _both(decoders, blobs, F.Y)
    assert [p for p, _ in jdec.last_paths] == ["host"]
    _assert_same_images(*out)


REFUSALS = [(k, ri, st) for k in ("wave", "transform") for ri in (0, 2)
            for st in (Status.INVALID_PARAMETER, Status.JPEG_NOT_SUPPORTED,
                       Status.BAD_JPEG)]


@pytest.mark.parametrize("kernel,ri,status", REFUSALS,
                         ids=[f"{k}-ri{r}-{s.name}" for k, r, s in REFUSALS])
def test_kernel_refusal_is_not_a_host_fallback(monkeypatch, kernel, ri,
                                               status):
    """Only the host packer's refusals send a group to the host path: a
    kernel wrapper that refuses its inputs fails the call."""
    from rocjpeg_tpu_torch.kernels import transform, wave
    mod = {"wave": wave, "transform": transform}[kernel]

    def refuse(*args):
        raise RocJpegError(status, "refused")

    monkeypatch.setattr(mod, "_check_inputs", refuse)
    dec = tapi.Decoder(device="cpu", device_entropy="on")
    with pytest.raises(RocJpegError) as ei:
        dec.decode_batched([tapi.JpegStream(b) for b in _blobs("420", ri)])
    assert ei.value.status == status
