"""The rest of the session API: ``decode_into``, the in-flight throttle and
``synchronize`` of the port against the JAX package's.

Counterparts of ``tests/test_decode_into.py``, ``tests/test_throttle.py``
and the chunking and back-pressure cases of
``tests/test_batch_semantics.py``. Both decoders take the same seeded
streams; what ``decode_into`` writes must be byte-equal (tolerance 0),
slack bytes untouched, and every refusal the same Status name and value.
The port's destinations are numpy buffers and raw pointers, as the JAX
package's, and also ``torch.Tensor``s on the decoder's device (here the
CPU, where the wrapper of K3 runs its plain version).
"""

import functools
import sys
import threading

import numpy as np
import pytest
import torch

from rocjpeg_tpu import api as japi
from rocjpeg_tpu import status as jstatus
from rocjpeg_tpu import types as jtypes
from rocjpeg_tpu_torch import api as tapi
from rocjpeg_tpu_torch import pipeline as tpipeline
from rocjpeg_tpu_torch import status as tstatus
from rocjpeg_tpu_torch import types as ttypes
from rocjpeg_tpu_torch.testing import encoder
from rocjpeg_tpu_torch.types import CropRectangle, OutputFormat
from test_torch_jaxlib import jax_native  # noqa: F401  (autouse)

F = OutputFormat
CSS_LIST = ["444", "440", "422", "420", "400"]
SIDES = {japi: (jtypes, jstatus), tapi: (ttypes, tstatus)}
POISON = 0xA5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _blob(css, seed=33, w=128, h=96, ri=6):
    return encoder.encode_planes(encoder.random_planes(css, w, h, seed=seed),
                                 css, restart_interval=ri)


@functools.lru_cache(maxsize=None)
def _jdec():
    return japi.Decoder()


@functools.lru_cache(maxsize=None)
def _tdec():
    return tapi.Decoder(device="cpu")


def _params(mod, fmt=F.NATIVE, crop=None):
    types = SIDES[mod][0]
    kwargs = {}
    if crop is not None:
        kwargs["crop_rectangle"] = types.CropRectangle(
            crop.left, crop.top, crop.right, crop.bottom)
    return types.DecodeParams(types.OutputFormat(int(fmt)), **kwargs)


@functools.lru_cache(maxsize=None)
def _shapes(css, fmt, crop=None):
    """(rows, row_bytes) per channel, from the JAX package's decode."""
    img = _jdec().decode(japi.JpegStream(_blob(css)), _params(japi, fmt, crop))
    return tuple(np.asarray(c).shape for c in img.channel if c is not None)


def _alloc(mod, shapes, slack, kind="numpy"):
    """A caller-allocated destination of ``mod``'s package, poison-filled:
    numpy buffers, or torch tensors for the port."""
    d = SIDES[mod][0].DecodedImage.empty()
    for ci, (rows, row) in enumerate(shapes):
        pitch = row + slack
        buf = np.full(rows * pitch, POISON, np.uint8)
        d.channel[ci] = torch.from_numpy(buf) if kind == "tensor" else buf
        d.pitch[ci] = pitch
    return d


def _bytes(d, ci):
    c = d.channel[ci]
    return c.numpy() if isinstance(c, torch.Tensor) else c


def _assert_same_dest(jd, td, shapes, slack):
    for ci, (rows, row) in enumerate(shapes):
        if jd.channel[ci] is None:
            assert td.channel[ci] is None
            continue
        a, b = _bytes(jd, ci), _bytes(td, ci)
        np.testing.assert_array_equal(a, b, err_msg=f"channel {ci}")
        if slack:
            assert (b.reshape(rows, row + slack)[:, row:] == POISON).all()
        assert (b.reshape(rows, row + slack)[:, :row] != POISON).any()


def _status(exc):
    return exc.status.name, int(exc.status)


def _both_raise(call):
    """``call(mod, dec)`` must raise on both sides with the same Status."""
    got = []
    for mod, dec in ((japi, _jdec()), (tapi, _tdec())):
        with pytest.raises(SIDES[mod][1].RocJpegError) as ei:
            call(mod, dec)
        got.append(_status(ei.value))
    assert got[0] == got[1]
    return got[0]


KINDS = ["numpy", "tensor"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fmt", list(F), ids=[f.name for f in F])
@pytest.mark.parametrize("css", CSS_LIST)
@pytest.mark.parametrize("slack", [0, 13])
def test_matrix_decode_into(css, fmt, slack, kind):
    shapes = _shapes(css, fmt)
    jd = _alloc(japi, shapes, slack)
    td = _alloc(tapi, shapes, slack, kind)
    _jdec().decode_into(japi.JpegStream(_blob(css)), jd, _params(japi, fmt))
    _tdec().decode_into(tapi.JpegStream(_blob(css)), td, _params(tapi, fmt))
    _assert_same_dest(jd, td, shapes, slack)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_into_batched(kind):
    """Two shape groups in one call, parallel sequences."""
    csss = ["420", "422", "420"]
    shapes = [_shapes(c, F.RGB) for c in csss]
    jds = [_alloc(japi, s, 7) for s in shapes]
    tds = [_alloc(tapi, s, 7, kind) for s in shapes]
    _jdec().decode_into([japi.JpegStream(_blob(c, seed=i))
                         for i, c in enumerate(csss)], jds,
                        _params(japi, F.RGB))
    _tdec().decode_into([tapi.JpegStream(_blob(c, seed=i))
                         for i, c in enumerate(csss)], tds,
                        _params(tapi, F.RGB))
    for jd, td, s in zip(jds, tds, shapes):
        _assert_same_dest(jd, td, s, 7)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fmt", [F.NATIVE, F.YUV_PLANAR, F.RGB_PLANAR],
                         ids=lambda f: f.name)
def test_decode_into_skips_unallocated_channels(kind, fmt):
    shapes = _shapes("420", fmt)
    jd = _alloc(japi, shapes, 5)
    td = _alloc(tapi, shapes, 5, kind)
    for d in (jd, td):
        for ci in range(1, 4):
            d.channel[ci] = None
    _jdec().decode_into(japi.JpegStream(_blob("420")), jd, _params(japi, fmt))
    _tdec().decode_into(tapi.JpegStream(_blob("420")), td, _params(tapi, fmt))
    _assert_same_dest(jd, td, shapes, 5)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("crop", [CropRectangle(16, 8, 80, 72),
                                  CropRectangle(5, 3, 70, 54)],
                         ids=["even", "odd"])
@pytest.mark.parametrize("fmt", [F.RGB, F.NATIVE], ids=lambda f: f.name)
def test_decode_into_with_crop(kind, crop, fmt):
    """The buffer need only fit the cropped dims."""
    shapes = _shapes("420", fmt, crop)
    jd = _alloc(japi, shapes, 9)
    td = _alloc(tapi, shapes, 9, kind)
    _jdec().decode_into(japi.JpegStream(_blob("420")), jd,
                        _params(japi, fmt, crop))
    _tdec().decode_into(tapi.JpegStream(_blob("420")), td,
                        _params(tapi, fmt, crop))
    _assert_same_dest(jd, td, shapes, 9)


def test_decode_into_length_mismatch():
    def call(mod, dec):
        dec.decode_into([mod.JpegStream(_blob("420"))] * 2,
                        [_alloc(mod, _shapes("420", F.Y), 0)],
                        _params(mod, F.Y))
    assert _both_raise(call) == ("INVALID_PARAMETER", -2)


@pytest.mark.parametrize("null", [None, 0, np.int64(0)],
                         ids=["None", "int0", "np.int64-0"])
def test_decode_into_null_channel0(null):
    def call(mod, dec):
        dest = SIDES[mod][0].DecodedImage.empty()
        dest.channel[0] = null
        dec.decode_into(mod.JpegStream(_blob("420")), dest)
    assert _both_raise(call) == ("INVALID_PARAMETER", -2)


def test_decode_into_null_channel0_tensor_route():
    """Channel 0 missing while another channel is a tensor."""
    dest = _alloc(tapi, _shapes("420", F.NATIVE), 0, "tensor")
    dest.channel[0] = None
    with pytest.raises(tstatus.RocJpegError) as ei:
        _tdec().decode_into(tapi.JpegStream(_blob("420")), dest)
    assert _status(ei.value) == ("INVALID_PARAMETER", -2)
    assert bool((dest.channel[1] == POISON).all())


@pytest.mark.parametrize("kind", KINDS)
def test_decode_into_short_pitch(kind):
    def call(mod, dec):
        dest = _alloc(mod, _shapes("420", F.RGB), 0,
                      kind if mod is tapi else "numpy")
        dest.pitch[0] -= 1
        dec.decode_into(mod.JpegStream(_blob("420")), dest,
                        _params(mod, F.RGB))
    assert _both_raise(call) == ("INVALID_PARAMETER", -2)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_into_undersized_buffer(kind):
    def call(mod, dec):
        dest = _alloc(mod, _shapes("420", F.Y), 0,
                      kind if mod is tapi else "numpy")
        dest.channel[0] = dest.channel[0][:-64]
        dec.decode_into(mod.JpegStream(_blob("420")), dest, _params(mod, F.Y))
    assert _both_raise(call) == ("INVALID_PARAMETER", -2)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_into_noncontiguous_buffer_rejected(kind):
    """A non-contiguous view is refused and nothing is written anywhere."""
    rows, row = _shapes("420", F.Y)[0]
    frames = []

    def call(mod, dec):
        frame = np.zeros((rows, row + 32), np.uint8)
        frames.append(frame)
        dest = SIDES[mod][0].DecodedImage.empty()
        view = frame[:, :row]
        dest.channel[0] = (torch.from_numpy(frame)[:, :row]
                           if mod is tapi and kind == "tensor" else view)
        dest.pitch[0] = row
        dec.decode_into(mod.JpegStream(_blob("420")), dest, _params(mod, F.Y))
    assert _both_raise(call) == ("INVALID_PARAMETER", -2)
    assert not any(f.any() for f in frames)


def test_decode_into_readonly_buffer():
    def call(mod, dec):
        dest = _alloc(mod, _shapes("420", F.Y), 0)
        dest.channel[0].flags.writeable = False
        dec.decode_into(mod.JpegStream(_blob("420")), dest, _params(mod, F.Y))
    assert _both_raise(call) == ("INVALID_PARAMETER", -2)


def test_decode_into_raw_pointer():
    """Raw pointer integers, non-tight pitch included."""
    (rows, row), = _shapes("420", F.RGB)
    pitch = row + 24
    backings = []
    for mod, dec in ((japi, _jdec()), (tapi, _tdec())):
        backing = np.full(rows * pitch, 0x5A, np.uint8)
        dest = SIDES[mod][0].DecodedImage.empty()
        dest.channel[0] = backing.ctypes.data
        dest.pitch[0] = pitch
        dec.decode_into(mod.JpegStream(_blob("420")), dest,
                        _params(mod, F.RGB))
        backings.append(backing)
    np.testing.assert_array_equal(*backings)
    win = backings[1].reshape(rows, pitch)
    assert (win[:, row:] == 0x5A).all() and (win[:, :row] != 0x5A).any()


@pytest.mark.parametrize("spoil", ["dtype", "device", "mixed"])
def test_decode_into_tensor_refusals(spoil):
    """What only the tensor route can be handed: another dtype, another
    device, or host buffers beside tensors in one call."""
    shapes = _shapes("420", F.YUV_PLANAR)
    dest = _alloc(tapi, shapes, 0, "tensor")
    rows, row = shapes[1]
    dest.channel[1] = {
        "dtype": torch.zeros(rows * row, dtype=torch.int8),
        "device": torch.zeros(rows * row, dtype=torch.uint8, device="meta"),
        "mixed": np.zeros(rows * row, np.uint8)}[spoil]
    with pytest.raises(tstatus.RocJpegError) as ei:
        _tdec().decode_into(tapi.JpegStream(_blob("420")), dest,
                            _params(tapi, F.YUV_PLANAR))
    assert _status(ei.value) == ("INVALID_PARAMETER", -2)
    assert bool((dest.channel[0] == POISON).all())


# --- the in-flight throttle --------------------------------------------------

def _state(dec):
    with dec._lock:
        return dec._outstanding, len(dec._inflight)


def _throttle_blob():
    return _blob("420", seed=3, ri=4)


@pytest.mark.parametrize("mod", [japi, tapi], ids=["jax", "port"])
def test_synchronize_drains_to_zero(mod):
    dec = japi.Decoder() if mod is japi else tapi.Decoder(device="cpu")
    dec.decode_batched([mod.JpegStream(_throttle_blob())] * 4)
    out, inflight = _state(dec)
    assert out == inflight >= 1  # every reservation has its token
    dec.synchronize()
    assert _state(dec) == (0, 0)
    dec.synchronize()  # idempotent
    assert _state(dec) == (0, 0)


def test_throttle_names_match_the_jax_package():
    jdec, tdec = japi.Decoder(), tapi.Decoder(device="cpu")
    for name in ("_max_inflight", "_inflight", "_outstanding", "_lock",
                 "_slot_cv", "_acquire_slot", "_register_token",
                 "_release_slot", "synchronize", "decode_into"):
        assert hasattr(jdec, name) and hasattr(tdec, name), name
    assert tdec._max_inflight == jdec._max_inflight == 2


def test_bound_holds_under_concurrency():
    """Eight threads on one handle: outstanding never exceeds the depth,
    no update is lost, and everything ends inside the time limit (a
    deadlock fails here instead of hanging the run)."""
    dec = tapi.Decoder(device="cpu")
    streams = [tapi.JpegStream(_throttle_blob())] * 2
    seen, errors = [], []
    stop = threading.Event()

    def sampler():
        while not stop.is_set():
            seen.append(_state(dec)[0])

    def worker():
        try:
            for _ in range(5):
                dec.decode_batched(streams, _params(tapi, F.Y))
        except BaseException as exc:  # reported below, in the main thread
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        s = threading.Thread(target=sampler, daemon=True)
        ts = [threading.Thread(target=worker, daemon=True) for _ in range(8)]
        s.start()
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        alive = [t for t in ts if t.is_alive()]
        stop.set()
        s.join(timeout=10)
    finally:
        sys.setswitchinterval(old)
    assert not alive, f"{len(alive)} workers still running: deadlock"
    assert not errors, errors
    assert not s.is_alive()
    dec.synchronize()
    assert seen and 0 <= min(seen) and max(seen) <= dec._max_inflight
    assert _state(dec) == (0, 0)


def test_no_slot_leak_on_decode_error():
    """A failing decode releases its reservation on both sides."""
    blob = _throttle_blob()
    bad = blob[:len(blob) // 2]
    for mod, dec in ((japi, japi.Decoder()), (tapi, tapi.Decoder(device="cpu"))):
        err = SIDES[mod][1].RocJpegError
        s = mod.JpegStream()
        s.parse(bad)
        for _ in range(4):  # more than the depth: a leak would hang here
            with pytest.raises(err):
                dec.decode(s)
        assert _state(dec)[0] == len(dec._inflight)
        dec.synchronize()
        assert _state(dec) == (0, 0)
        good = dec.decode(mod.JpegStream(blob), _params(mod, F.Y))
        assert tuple(good.channel[0].shape) == (96, 128)


def test_no_slot_leak_when_a_wait_raises():
    """A token whose wait raises still gives its slot back, in
    ``_acquire_slot`` and in ``synchronize``."""
    dec = tapi.Decoder(device="cpu")

    class Failing:
        def synchronize(self):
            raise RuntimeError("device fault")

    for drain in (dec._acquire_slot, dec.synchronize):
        with dec._lock:
            dec._outstanding = dec._max_inflight
            dec._inflight[:] = [Failing(), Failing()]
        with pytest.raises(RuntimeError):
            drain()
        assert _state(dec) == (1, 1)
        dec._inflight.clear()
        dec._outstanding = 0


def test_no_slot_leak_when_a_destination_is_refused():
    dec = tapi.Decoder(device="cpu")
    dest = _alloc(tapi, _shapes("420", F.Y), 0, "tensor")
    dest.pitch[0] = 1
    for _ in range(3):
        with pytest.raises(tstatus.RocJpegError):
            dec.decode_into(tapi.JpegStream(_blob("420")), dest,
                            _params(tapi, F.Y))
    assert _state(dec) == (0, 0)


# --- chunking and back-pressure ----------------------------------------------

def _blobs(n):
    return [_blob("420", seed=s, ri=4) for s in range(n)]


def test_decode_batched_chunks_by_lane_budget(monkeypatch):
    """A group wider than spec.num_decode_lanes splits into chunks of that
    width on the host path, each its own device pass, bytes as the JAX
    package's."""
    blobs = _blobs(5)
    jdec = japi.Decoder(spec=jtypes.TpuDecodeSpec(name="t", num_decode_lanes=2),
                        device_entropy="off")
    tdec = tapi.Decoder(device="cpu", device_entropy="off",
                        spec=ttypes.GpuDecodeSpec(name="t", num_decode_lanes=2))
    calls = []
    real = tpipeline.decode_group

    def spy(params_list, *a, **k):
        calls.append(len(params_list))
        return real(params_list, *a, **k)

    monkeypatch.setattr(tpipeline, "decode_group", spy)
    want = jdec.decode_batched([japi.JpegStream(b) for b in blobs],
                               _params(japi, F.Y))
    got = tdec.decode_batched([tapi.JpegStream(b) for b in blobs],
                              _params(tapi, F.Y))
    assert calls == [2, 2, 1]
    assert ([(p, list(i)) for p, i in tdec.last_paths]
            == [(p, list(i)) for p, i in jdec.last_paths]
            == [("host", [0, 1]), ("host", [2, 3]), ("host", [4])])
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a.channel[0]),
                                      b.channel[0].numpy())


@pytest.mark.parametrize("entropy, path", [("off", "host"), ("on", "wave")])
def test_cpu_decoder_chunks_as_the_jax_package(entropy, path):
    """Without a spec a CPU decoder takes the CPU's (8 lanes, the JAX
    package's ``_CPU_SPEC``): 10 same-shape images make chunks of 8 + 2 in
    both packages, bytes equal."""
    blobs = _blobs(10)
    jdec = japi.Decoder(device_entropy=entropy)
    tdec = tapi.Decoder(device="cpu", device_entropy=entropy)
    assert tdec.spec.num_decode_lanes == jdec.spec.num_decode_lanes == 8
    want = jdec.decode_batched([japi.JpegStream(b) for b in blobs],
                               _params(japi, F.Y))
    got = tdec.decode_batched([tapi.JpegStream(b) for b in blobs],
                              _params(tapi, F.Y))
    assert ([(p, list(i)) for p, i in tdec.last_paths]
            == [(p, list(i)) for p, i in jdec.last_paths]
            == [(path, list(range(8))), (path, [8, 9])])
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a.channel[0]),
                                      b.channel[0].numpy())


def test_spec_for_device():
    """The CPU gets 8 lanes; a card gets its table entry or the default
    width under its own name."""
    cpu = ttypes.spec_for_device(torch.device("cpu"))
    assert (cpu.name, cpu.num_decode_lanes) == ("cpu", 8)
    assert ttypes.spec_for_device("cpu") is cpu


@pytest.mark.parametrize("name, lanes", [
    ("NVIDIA H100 80GB HBM3", dict(ttypes._GPU_LANES)["NVIDIA H100"]),
    ("Some Other GPU", ttypes.GpuDecodeSpec().num_decode_lanes)])
def test_spec_for_device_by_card_name(monkeypatch, name, lanes):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev: name)
    spec = ttypes.spec_for_device(torch.device("cuda", 0))
    assert (spec.name, spec.num_decode_lanes) == (name, lanes)


def test_decode_batched_chunks_device_path():
    blobs = _blobs(5)
    jdec = japi.Decoder(spec=jtypes.TpuDecodeSpec(name="t", num_decode_lanes=2),
                        device_entropy="on")
    tdec = tapi.Decoder(device="cpu", device_entropy="on",
                        spec=ttypes.GpuDecodeSpec(name="t", num_decode_lanes=2))
    want = jdec.decode_batched([japi.JpegStream(b) for b in blobs],
                               _params(japi, F.Y))
    got = tdec.decode_batched([tapi.JpegStream(b) for b in blobs],
                              _params(tapi, F.Y))
    assert len(tdec.last_error_flags) == len(jdec.last_error_flags) == 3
    assert [p for p, _ in tdec.last_paths] == ["wave"] * 3
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a.channel[0]),
                                      b.channel[0].numpy())


def test_decode_into_chunks_keep_each_images_destination():
    """Destinations follow their streams through grouping and chunking."""
    csss = ["420", "444", "420", "420", "444"]
    tdec = tapi.Decoder(device="cpu",
                        spec=ttypes.GpuDecodeSpec(name="t", num_decode_lanes=2))
    shapes = [_shapes(c, F.RGB) for c in csss]
    jds = [_alloc(japi, s, 3) for s in shapes]
    tds = [_alloc(tapi, s, 3, "tensor") for s in shapes]
    _jdec().decode_into([japi.JpegStream(_blob(c, seed=i))
                         for i, c in enumerate(csss)], jds,
                        _params(japi, F.RGB))
    tdec.decode_into([tapi.JpegStream(_blob(c, seed=i))
                      for i, c in enumerate(csss)], tds, _params(tapi, F.RGB))
    assert [list(i) for _, i in tdec.last_paths] == [[0, 2], [3], [1, 4]]
    for jd, td, s in zip(jds, tds, shapes):
        _assert_same_dest(jd, td, s, 3)


@pytest.mark.parametrize("entropy", ["off", "on"])
def test_inflight_backpressure_bounded(entropy):
    """Both paths register a token per chunk, so at most _max_inflight are
    outstanding after any call."""
    blobs = _blobs(3)
    dec = tapi.Decoder(device="cpu", device_entropy=entropy,
                       check_errors=False,
                       spec=ttypes.GpuDecodeSpec(name="t", num_decode_lanes=1))
    streams = [tapi.JpegStream(b) for b in blobs]
    for _ in range(3):
        dec.decode_batched(streams, _params(tapi, F.Y))
        assert _state(dec) == (dec._max_inflight, dec._max_inflight)
    dec.synchronize()
    assert _state(dec) == (0, 0)


def test_session_names_exported():
    import rocjpeg_tpu
    import rocjpeg_tpu_torch
    for name in ("DecodedImage", "ImageInfo", "DecodeParams", "CropRectangle",
                 "OutputFormat", "ChromaSubsampling", "RocJpegError",
                 "Status", "get_error_name"):
        assert hasattr(rocjpeg_tpu, name) and hasattr(rocjpeg_tpu_torch, name)
    assert rocjpeg_tpu_torch.Backend is ttypes.Backend
    assert ({m.name: int(m) for m in ttypes.Backend}
            == {m.name: int(m) for m in jtypes.Backend})


def _refusal(fn):
    """(name, value) of the RocJpegError ``fn`` raises, of either package;
    any other exception fails the test."""
    try:
        fn()
    except (tstatus.RocJpegError, jstatus.RocJpegError) as e:
        return e.status.name, int(e.status)
    raise AssertionError("no RocJpegError raised")


@pytest.mark.parametrize("backend,want", [
    (1, ("NOT_IMPLEMENTED", -12)), (7, ("INVALID_PARAMETER", -2))])
def test_decoder_backend_refusals_match_the_jax_package(backend, want):
    """The first positional argument is the backend, as in the JAX
    package: HYBRID is NOT_IMPLEMENTED, an unknown value INVALID_PARAMETER,
    before any device is looked at."""
    assert _refusal(lambda: japi.Decoder(backend)) == want
    assert _refusal(lambda: tapi.Decoder(backend)) == want
    assert _refusal(lambda: tapi.Decoder(backend, device="cpu")) == want
    assert _refusal(lambda: tapi.Decoder(backend, 0)) == want


@pytest.mark.parametrize("args", [(), (0, 5), (0, 99), (0, -1),
                                  (ttypes.Backend.HARDWARE, 1)])
def test_decoder_without_cuda_is_not_initialized(monkeypatch, args):
    """No CUDA: every device_id gives NOT_INITIALIZED as a RocJpegError
    (never torch's bare RuntimeError), as an absent device does in the JAX
    package."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _refusal(lambda: tapi.Decoder(*args)) == ("NOT_INITIALIZED", -1)
    assert _refusal(lambda: japi.Decoder(0, 99)) == ("NOT_INITIALIZED", -1)


@pytest.mark.parametrize("device_id", [-1, 1, 5])
def test_decoder_device_id_out_of_range(monkeypatch, device_id):
    """CUDA present with one device: an index past it (or negative) is
    NOT_INITIALIZED, the reference's device-count check."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert _refusal(lambda: tapi.Decoder(0, device_id)) == (
        "NOT_INITIALIZED", -1)
    assert _refusal(lambda: tapi.Decoder(device=device_id)) == (
        "NOT_INITIALIZED", -1)


def test_decoder_takes_the_jax_argument_order():
    """(backend, device_id, spec, device_entropy, check_errors) by
    position, as the JAX package's; ``device`` is keyword-only and
    overrides device_id."""
    spec = ttypes.GpuDecodeSpec(name="x", num_decode_lanes=3)
    dec = tapi.Decoder(ttypes.Backend.HARDWARE, 7, spec, "on", False,
                       device="cpu")
    assert dec.spec is spec
    assert (dec._device.type, dec._device_entropy, dec._check_errors) == (
        "cpu", "on", False)
    with pytest.raises(TypeError):
        tapi.Decoder(0, 0, None, "on", True, "cpu")
    img = dec.decode(tapi.JpegStream(_blob("420")))
    assert img.channel[0].device.type == "cpu"
