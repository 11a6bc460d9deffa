"""The port's C ABI against the JAX package's.

Mirror of ``tests/test_capi.py``: the status-returning functional API
(``rocjpeg_tpu_torch.capi``, every case with the same Status and bytes as
``rocjpeg_tpu.capi``), the embedded-CPython library
``librocjpeg_tpu_torch.so`` loaded in-process through ctypes, and the two C
samples run as subprocesses (the reference's CTest model: exit 0 = pass),
their output byte-equal to the port's numpy oracle. The sessions run on the
host through ``ROCJPEG_TPU_TORCH_DEVICE=cpu``; without it and without CUDA
every entry point that opens one returns NOT_INITIALIZED. Last, the port's
copy of the header declares exactly what ``include/rocjpeg_tpu.h`` does.
"""

import ctypes
import os
import re
import subprocess
import sys
import sysconfig

import numpy as np
import pytest
import torch

from rocjpeg_tpu import capi as jcapi
from rocjpeg_tpu_torch import capi as tcapi
from rocjpeg_tpu_torch.core import golden
from rocjpeg_tpu_torch.runtime import build
from rocjpeg_tpu_torch.status import Status
from rocjpeg_tpu_torch.testing import encoder
from rocjpeg_tpu_torch.types import CropRectangle, OutputFormat
from test_torch_jaxlib import jax_native  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"jax": jcapi, "port": tcapi}


@pytest.fixture(scope="module")
def jpeg_420():
    return encoder.encode_planes(
        encoder.random_planes("420", 128, 96, seed=3), "420",
        restart_interval=4)


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv(tcapi.DEVICE_ENV, "cpu")


def _status(st):
    return st.name, int(st)


def _session(mod, blob):
    _, stream = mod.stream_create()
    assert mod.stream_parse(stream, blob) == 0
    st, handle = mod.create()
    assert st == 0, mod.get_last_error(handle)
    return handle, stream


# ----------------------------------------------------------------------
# Python-level functional API, both packages on the same inputs

def test_stream_lifecycle(jpeg_420):
    got = {}
    for side, mod in SIDES.items():
        st, stream = mod.stream_create()
        got[side] = [_status(st), _status(mod.stream_parse(stream, jpeg_420)),
                     _status(mod.stream_destroy(stream)),
                     _status(mod.stream_destroy(None)),
                     _status(mod.stream_parse(None, jpeg_420))]
    assert got["port"] == got["jax"]
    assert got["port"][:3] == [("SUCCESS", 0)] * 3


def test_parse_bad_jpeg_captures_error():
    got = {}
    for side, mod in SIDES.items():
        _, stream = mod.stream_create()
        got[side] = _status(mod.stream_parse(stream, b"\x00\x01garbage"))
        assert mod.get_last_error(stream) != ""
    assert got["port"] == got["jax"] == ("BAD_JPEG", -3)


@pytest.mark.parametrize("backend", [1, 7])
def test_create_bad_backend(on_cpu, backend):
    got = {}
    for side, mod in SIDES.items():
        st, handle = mod.create(backend=backend)
        assert handle is None
        got[side] = _status(st)
    assert got["port"] == got["jax"]
    if backend == 1:
        assert got["port"] == ("NOT_IMPLEMENTED", -12)


def test_create_without_cuda_or_knob(monkeypatch):
    monkeypatch.delenv(tcapi.DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    st, handle = tcapi.create()
    assert (_status(st), handle) == (("NOT_INITIALIZED", -1), None)


def test_create_refuses_other_knob_values(monkeypatch):
    for value in ("cuda", "gpu", ""):
        monkeypatch.setenv(tcapi.DEVICE_ENV, value)
        st, handle = tcapi.create()
        assert (_status(st), handle) == (("INVALID_PARAMETER", -2), None)


def test_get_image_info(on_cpu, jpeg_420):
    got = {}
    for side, mod in SIDES.items():
        handle, stream = _session(mod, jpeg_420)
        st, *rest = mod.get_image_info(handle, stream)
        got[side] = (_status(st), *rest)
        bad = mod.get_image_info(None, stream)
        got[side] += (_status(bad[0]), *bad[1:])
    assert got["port"] == got["jax"]
    assert got["port"][1:3] == (3, 3)  # 3 components, CSS_420
    assert got["port"][3][:3] == (128, 64, 64)
    assert got["port"][4][:3] == (96, 48, 48)


def _decode_both(blob, fmt, chans_of, pitches, crop=(0, 0, 0, 0)):
    """Decode on both sides into the buffers ``chans_of`` makes; returns
    {side: (status, buffers, last error)}."""
    got = {}
    for side, mod in SIDES.items():
        handle, stream = _session(mod, blob)
        bufs, chans = chans_of()
        st = mod.decode(handle, stream, int(fmt), crop, chans, pitches)
        got[side] = (_status(st), bufs, mod.get_last_error(handle))
    return got


def test_decode_into_numpy(on_cpu, jpeg_420):
    ref = golden.decode(jpeg_420, OutputFormat.RGB)[0][0]

    def chans():
        dest = np.zeros(ref.size, np.uint8)
        return [dest], [dest, None, None, None]

    got = _decode_both(jpeg_420, OutputFormat.RGB, chans, [3 * 128, 0, 0, 0])
    assert got["port"][0] == got["jax"][0] == ("SUCCESS", 0)
    np.testing.assert_array_equal(got["port"][1][0], got["jax"][1][0])
    np.testing.assert_array_equal(got["port"][1][0].reshape(ref.shape), ref)


@pytest.mark.parametrize("fmt", list(OutputFormat), ids=lambda f: f.name)
def test_decode_into_pointer_with_padded_pitch(on_cpu, jpeg_420, fmt):
    """Caller pitch > row bytes: rows land at pitch offsets, padding intact
    (CopyChannel semantics, src/rocjpeg_decoder.cpp:372-399), for every
    output format and a valid crop."""
    crop = (16, 8, 80, 72)
    ref = golden.decode(jpeg_420, fmt, CropRectangle(*crop))
    pitches = [a.shape[1] + 64 for a, _ in ref] + [0] * (4 - len(ref))

    def chans():
        bufs = [np.full(a.shape[0] * p, 0xAB, np.uint8)
                for (a, _), p in zip(ref, pitches)]
        return bufs, [b.ctypes.data for b in bufs] + [0] * (4 - len(bufs))

    got = _decode_both(jpeg_420, fmt, chans, pitches, crop)
    assert got["port"][0] == got["jax"][0] == ("SUCCESS", 0)
    for (a, _), p, mine, theirs in zip(ref, pitches, got["port"][1],
                                       got["jax"][1]):
        np.testing.assert_array_equal(mine, theirs)
        rows = mine.reshape(a.shape[0], p)
        np.testing.assert_array_equal(rows[:, :a.shape[1]], a)
        assert (rows[:, a.shape[1]:] == 0xAB).all()  # padding untouched


def test_decode_pitch_too_small(on_cpu, jpeg_420):
    def chans():
        dest = np.zeros(3 * 128 * 96, np.uint8)
        return [dest], [dest, None, None, None]

    got = _decode_both(jpeg_420, OutputFormat.RGB, chans, [100, 0, 0, 0])
    assert got["port"][0] == got["jax"][0] == ("INVALID_PARAMETER", -2)
    assert "pitch" in got["port"][2]
    assert not got["port"][1][0].any()


def test_decode_null_primary_channel(on_cpu, jpeg_420):
    for null in (None, 0):
        got = _decode_both(jpeg_420, OutputFormat.Y,
                           lambda: ([], [null] * 4), [0, 0, 0, 0])
        assert got["port"][0] == got["jax"][0] == ("INVALID_PARAMETER", -2)


def test_decode_batched_bad_arguments(on_cpu, jpeg_420):
    got = {}
    for side, mod in SIDES.items():
        handle, stream = _session(mod, jpeg_420)
        got[side] = [_status(mod.decode_batched(*args)) for args in (
            (None, [stream], 2, (0, 0, 0, 0), [[None] * 4], [[0] * 4]),
            (handle, [], 2, (0, 0, 0, 0), [], []),
            (handle, [stream], 2, (0, 0, 0, 0), [], [[0] * 4]))]
        got[side].append(_status(mod.destroy(handle)))
        got[side].append(_status(mod.destroy(None)))
    assert got["port"] == got["jax"]
    assert got["port"][:3] == [("INVALID_PARAMETER", -2)] * 3


# ----------------------------------------------------------------------
# The port's shared library, loaded in-process

@pytest.fixture(scope="module")
def capi_dir():
    return build.build_capi()


@pytest.fixture(scope="module")
def libso(capi_dir):
    lib = ctypes.CDLL(os.path.join(capi_dir, build.CAPI_LIBRARY))
    lib.rocJpegGetErrorName.restype = ctypes.c_char_p
    lib.rocJpegGetLastError.restype = ctypes.c_char_p
    vp = ctypes.c_void_p
    lib.rocJpegStreamCreate.argtypes = [ctypes.POINTER(vp)]
    lib.rocJpegStreamParse.argtypes = [ctypes.c_void_p, ctypes.c_size_t, vp]
    lib.rocJpegStreamDestroy.argtypes = [vp]
    lib.rocJpegCreate.argtypes = [ctypes.c_int, ctypes.c_int,
                                  ctypes.POINTER(vp)]
    lib.rocJpegDestroy.argtypes = [vp]
    lib.rocJpegGetLastError.argtypes = [vp]
    return lib


class _DecodeParams(ctypes.Structure):
    _fields_ = [("output_format", ctypes.c_int),
                ("left", ctypes.c_int16), ("top", ctypes.c_int16),
                ("right", ctypes.c_int16), ("bottom", ctypes.c_int16),
                ("target_width", ctypes.c_uint32),
                ("target_height", ctypes.c_uint32)]


class _Image(ctypes.Structure):
    _fields_ = [("channel", ctypes.c_void_p * 4),
                ("pitch", ctypes.c_uint32 * 4)]


def _parsed_stream(lib, blob):
    stream = ctypes.c_void_p()
    assert lib.rocJpegStreamCreate(ctypes.byref(stream)) == 0
    buf = (ctypes.c_ubyte * len(blob)).from_buffer_copy(blob)
    assert lib.rocJpegStreamParse(buf, len(blob), stream) == 0
    return stream


def test_cabi_error_name(libso):
    assert libso.rocJpegGetErrorName(0) == b"ROCJPEG_STATUS_SUCCESS"
    assert libso.rocJpegGetErrorName(-3) == b"ROCJPEG_STATUS_BAD_JPEG"
    assert libso.rocJpegGetErrorName(99) == b"UNKNOWN_ROCJPEG_STATUS"
    for st in Status:
        assert libso.rocJpegGetErrorName(int(st)) == \
            f"ROCJPEG_STATUS_{st.name}".encode()


def test_cabi_full_decode(libso, jpeg_420, on_cpu):
    handle = ctypes.c_void_p()
    assert libso.rocJpegCreate(0, 0, ctypes.byref(handle)) == 0
    stream = _parsed_stream(libso, jpeg_420)
    nc = ctypes.c_uint8()
    css = ctypes.c_int()
    widths = (ctypes.c_uint32 * 4)()
    heights = (ctypes.c_uint32 * 4)()
    assert libso.rocJpegGetImageInfo(handle, stream, ctypes.byref(nc),
                                     ctypes.byref(css), widths, heights) == 0
    assert (nc.value, css.value) == (3, 3)
    assert list(widths) == [128, 64, 64, 0]
    assert list(heights) == [96, 48, 48, 0]

    ref = golden.decode(jpeg_420, OutputFormat.RGB)[0][0]
    pitch = ref.shape[1] + 16
    dest = np.full((ref.shape[0], pitch), 0xAB, np.uint8)
    img = _Image()
    img.channel[0] = dest.ctypes.data
    img.pitch[0] = pitch
    params = _DecodeParams(output_format=int(OutputFormat.RGB))
    assert libso.rocJpegDecode(handle, stream, ctypes.byref(params),
                               ctypes.byref(img)) == 0
    np.testing.assert_array_equal(dest[:, :ref.shape[1]], ref)
    assert (dest[:, ref.shape[1]:] == 0xAB).all()

    assert libso.rocJpegStreamDestroy(stream) == 0
    assert libso.rocJpegDestroy(handle) == 0


def test_cabi_decode_batched(libso, jpeg_420, on_cpu):
    n = 3
    handle = ctypes.c_void_p()
    assert libso.rocJpegCreate(0, 0, ctypes.byref(handle)) == 0
    streams = (ctypes.c_void_p * n)()
    for i in range(n):
        streams[i] = _parsed_stream(libso, jpeg_420)
    ref = golden.decode(jpeg_420, OutputFormat.Y)[0][0]
    dests = [np.zeros(ref.shape, np.uint8) for _ in range(n)]
    images = (_Image * n)()
    for i in range(n):
        images[i].channel[0] = dests[i].ctypes.data
        images[i].pitch[0] = ref.shape[1]
    params = _DecodeParams(output_format=int(OutputFormat.Y))
    assert libso.rocJpegDecodeBatched(handle, streams, n,
                                      ctypes.byref(params), images) == 0
    for d in dests:
        np.testing.assert_array_equal(d, ref)
    for i in range(n):
        assert libso.rocJpegStreamDestroy(streams[i]) == 0
    assert libso.rocJpegDestroy(handle) == 0


def test_cabi_bad_jpeg_status_and_last_error(libso):
    stream = ctypes.c_void_p()
    assert libso.rocJpegStreamCreate(ctypes.byref(stream)) == 0
    bad = b"\x00\x01not a jpeg"
    buf = (ctypes.c_ubyte * len(bad)).from_buffer_copy(bad)
    assert libso.rocJpegStreamParse(buf, len(bad), stream) == -3  # BAD_JPEG
    assert b"SOI" in libso.rocJpegGetLastError(stream)
    assert libso.rocJpegStreamDestroy(stream) == 0


def test_cabi_hybrid_backend_not_implemented(libso, on_cpu):
    handle = ctypes.c_void_p()
    assert libso.rocJpegCreate(1, 0, ctypes.byref(handle)) == -12
    assert libso.rocJpegCreate(7, 0, ctypes.byref(handle)) == -11
    assert handle.value is None


def test_cabi_not_initialized_without_cuda_or_knob(libso, monkeypatch):
    monkeypatch.delenv(tcapi.DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    handle = ctypes.c_void_p()
    assert libso.rocJpegCreate(0, 0, ctypes.byref(handle)) == -1
    assert handle.value is None


# ----------------------------------------------------------------------
# The C samples as subprocesses

def _sample_env(cpu=True):
    """The embedded interpreter finds the package through ROCJPEG_TPU_ROOT,
    and torch and numpy through this interpreter's sys.path."""
    env = dict(os.environ, ROCJPEG_TPU_ROOT=REPO,
               PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    env.pop(tcapi.DEVICE_ENV, None)
    if cpu:
        env[tcapi.DEVICE_ENV] = "cpu"
    return env


def _run_sample(capi_dir, name, args, cpu=True):
    return subprocess.run([os.path.join(capi_dir, name), *args],
                          env=_sample_env(cpu), capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize("crop", [None, CropRectangle(16, 8, 80, 72)],
                         ids=["full", "crop"])
@pytest.mark.parametrize("fmt", ["rgb", "native"])
def test_c_sample_subprocess(capi_dir, jpeg_420, tmp_path, fmt, crop):
    src = tmp_path / "img.jpg"
    out = tmp_path / "out.raw"
    src.write_bytes(jpeg_420)
    args = ["-i", str(src), "-fmt", fmt, "-o", str(out)]
    if crop:
        args += ["-crop", f"{crop.left},{crop.top},{crop.right},{crop.bottom}"]
    r = _run_sample(capi_dir, "jpegdecode_c", args)
    assert r.returncode == 0, r.stdout + r.stderr
    ref = golden.decode(jpeg_420, {"rgb": OutputFormat.RGB,
                                   "native": OutputFormat.NATIVE}[fmt], crop)
    want = b"".join(np.ascontiguousarray(a).tobytes() for a, _ in ref)
    assert out.read_bytes() == want


def test_c_perf_sample_threads(capi_dir, tmp_path):
    for i, css in enumerate(("420", "422", "444")):
        (tmp_path / f"{css}.jpg").write_bytes(encoder.encode_planes(
            encoder.random_planes(css, 96, 64, seed=i), css,
            restart_interval=2))
    r = _run_sample(capi_dir, "jpegdecodeperf_c",
                    ["-i", str(tmp_path), "-t", "2", "-b", "2", "-n", "2"])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "decoded 8 images in 4 batches, skipped 0" in r.stdout


def test_c_sample_without_the_knob(capi_dir, jpeg_420, tmp_path):
    """No knob: the session is the CUDA device's, and without one the
    sample fails with NOT_INITIALIZED rather than decode on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the sample decodes on it")
    src = tmp_path / "img.jpg"
    src.write_bytes(jpeg_420)
    r = _run_sample(capi_dir, "jpegdecode_c", ["-i", str(src)], cpu=False)
    assert r.returncode == 1
    assert "ROCJPEG_STATUS_NOT_INITIALIZED" in r.stderr


# ----------------------------------------------------------------------
# The build

def _capi_copy(tmp_path, monkeypatch):
    import shutil
    src = tmp_path / "capi"
    shutil.copytree(build.CAPI_SRC, src)
    monkeypatch.setattr(build, "CAPI_SRC", str(src))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "out"))
    return src


def test_capi_build_failure_raises(tmp_path, monkeypatch):
    """A shim that does not compile raises with the compiler's output and
    leaves no build behind; nothing skips or falls back."""
    src = _capi_copy(tmp_path, monkeypatch)
    with open(src / "rocjpeg_capi.cpp", "a") as f:
        f.write("this is not C++\n")
    with pytest.raises(build.HostBuildError) as ei:
        build.build_capi()
    assert "g++ failed" in str(ei.value)
    assert not list((tmp_path / "out").glob("capi_*"))


def test_capi_build_name_follows_sources(tmp_path, monkeypatch):
    """An edited source or sample gets a new build directory; the flags
    are the running interpreter's."""
    src = _capi_copy(tmp_path, monkeypatch)
    before = build.capi_dir()
    with open(src / "samples" / "jpegdecode_c.cpp", "a") as f:
        f.write("// edited\n")
    assert build.capi_dir() != before
    compile_flags, link_flags = build.python_flags()
    assert f"-I{sysconfig.get_paths()['include']}" in compile_flags
    assert f"-lpython{sysconfig.get_config_var('LDVERSION')}" in link_flags


# ----------------------------------------------------------------------
# The ABI

def _declarations(path):
    with open(path) as f:
        text = f.read()
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    text = re.sub(r"//[^\n]*", "", text)
    return [line.strip() for line in text.splitlines() if line.strip()]


def test_header_copy_declares_the_same_abi():
    mine = _declarations(os.path.join(build.CAPI_SRC, "include",
                                      "rocjpeg_tpu.h"))
    theirs = _declarations(os.path.join(REPO, "include", "rocjpeg_tpu.h"))
    assert mine == theirs
    assert sum("ROCJPEGAPI rocJpeg" in line for line in mine) == 9
