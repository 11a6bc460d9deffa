"""The port's multi-device decode against the JAX package's ``dist``.

Mirror of ``tests/test_dist.py``: the port's ``MeshDecoder`` over 8 CPU
rows (``make_mesh(devices=["cpu"] * 8, space=s)``) against the JAX
package's over the 8 virtual CPU devices of ``tests/conftest.py``, on the
same seeded blobs, bytes and pitches equal (tolerance 0) in every case:
RGB at space 1 / 2 / 4, NATIVE / YUV_PLANAR / Y at space 2, a crop, mixed
shapes, a DRI=0 group on the port's ``'wave-virtual'`` path, and
``decode_batched_local`` (``global_arrays`` False and True). A batch of
10 over 8 rows leaves shards uneven and some empty. The error cases pin
the JAX package's fault (its ``MeshDecoder`` never reads its wave's error
flags) beside the port's ``BAD_JPEG`` with the caller's index. The space
cases run the host-entropy path at space 2 and 4 (every format at 4:2:0,
RGB and NATIVE at 4:2:2, 4:4:4 and 4:0:0, a crop, luma bands that end
halfway through an MCU row, 'auto'), each against the JAX package at the
same space and the port's own mesh of as many rows at space 1, with K2
seen to run once a band with the band's dims.
"""

import ast
import functools
import threading

import numpy as np
import pytest
import torch

from rocjpeg_tpu import api as japi
from rocjpeg_tpu import types as jtypes
from rocjpeg_tpu.dist import mesh as jmesh
from rocjpeg_tpu.dist import sharding as jsharding
from rocjpeg_tpu_torch import api as tapi
from rocjpeg_tpu_torch.dist import mesh as tmesh
from rocjpeg_tpu_torch.dist import sharding as tsharding
from rocjpeg_tpu_torch.kernels import epilogue, transform, wave
from rocjpeg_tpu_torch.status import RocJpegError, Status
from rocjpeg_tpu_torch.testing import encoder
from rocjpeg_tpu_torch.types import CropRectangle, DecodeParams, OutputFormat
from test_torch_jaxlib import jax_native  # noqa: F401  (autouse)

F = OutputFormat
CPU8 = ["cpu"] * 8
CORRUPT = 6  # the batch index of the corrupt scan in the error cases


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _blobs(ri=4, n=10):
    return tuple(encoder.encode_planes(
        encoder.random_planes("420", 128, 96, seed=s), "420",
        restart_interval=ri) for s in range(n))


@functools.lru_cache(maxsize=None)
def _mixed():
    extra = encoder.encode_planes(encoder.random_planes("444", 64, 64, 99),
                                  "444")
    return _blobs()[:3] + (extra,)


def _garbled(blob):
    """``blob`` with its scan's payload bytes garbled and its restart
    markers kept: the packer finds every segment, the wave flags them."""
    data = bytearray(blob)
    sos = data.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    for i in range(start + 16, len(data) - 3):
        if 0xFF not in (data[i - 1], data[i], data[i + 1], data[i] ^ 0x5A):
            data[i] ^= 0x5A
    return bytes(data)


@functools.lru_cache(maxsize=None)
def _corrupt_batch():
    blobs = list(_blobs())
    blobs[CORRUPT] = _garbled(blobs[CORRUPT])
    return tuple(blobs)


def _jparams(fmt, crop=None):
    crop = jtypes.CropRectangle(*crop) if crop else jtypes.CropRectangle()
    return jtypes.DecodeParams(output_format=jtypes.OutputFormat(int(fmt)),
                               crop_rectangle=crop)


def _tparams(fmt, crop=None):
    return DecodeParams(output_format=fmt,
                        crop_rectangle=CropRectangle(*crop) if crop
                        else CropRectangle())


@functools.lru_cache(maxsize=None)
def _jax_mesh_decode(blobs, fmt, space=1, crop=None, entropy="auto"):
    """The JAX MeshDecoder's channels: per image [(array, pitch), ...]."""
    md = jsharding.MeshDecoder(mesh=jmesh.make_mesh(space=space),
                               device_entropy=entropy)
    imgs = md.decode_batched([japi.JpegStream(b) for b in blobs],
                             _jparams(fmt, crop))
    return [[(np.asarray(c), p) for c, p in zip(img.channel, img.pitch)
             if c is not None] for img in imgs]


def _port_mesh(space=1, entropy="auto", **kwargs):
    return tsharding.MeshDecoder(tmesh.make_mesh(devices=CPU8, space=space),
                                 device_entropy=entropy, **kwargs)


def _assert_same(want, imgs, md):
    """Bytes and pitches equal, each image's channels on its row's
    device."""
    assert len(imgs) == len(want)
    row_of = {i: row for row, idxs, _, _ in md._shards() for i in idxs}
    for i, (chans, img) in enumerate(zip(want, imgs)):
        got = [(c, p) for c, p in zip(img.channel, img.pitch)
               if c is not None]
        assert len(got) == len(chans)
        for (a, pa), (b, pb) in zip(chans, got):
            assert pa == pb
            assert b.device == md.mesh.devices[row_of[i]][0]
            np.testing.assert_array_equal(b.numpy(), a)


def _contiguous(n, rows):
    """The expected split: ceil(n / rows) images a shard, in batch order,
    empty shards dropped."""
    per = -(-n // rows)
    return [list(range(lo, min(lo + per, n))) for lo in range(0, n, per)]


# The device path's plain K1 steps in Python: each thread of a row holds the
# interpreter lock for most of its work, so the CPU cases of the device
# path keep to two rows.
@pytest.mark.parametrize("space, entropy", [(1, "auto"), (2, "auto"),
                                            (4, "auto"), (4, "on")])
def test_mesh_decode_bit_exact(space, entropy):
    md = _port_mesh(space, entropy)
    blobs = _blobs()
    imgs = md.decode_batched([tapi.JpegStream(b) for b in blobs],
                             _tparams(F.RGB))
    _assert_same(_jax_mesh_decode(blobs, F.RGB, space), imgs, md)
    rows = 8 // space
    assert md.mesh.shape == {"data": rows, "space": space}
    assert [list(i) for _, i in md.last_paths] == _contiguous(10, rows)
    assert {p for p, _ in md.last_paths} == (
        {"host"} if entropy == "auto" else {"wave"})
    md.close()


@pytest.mark.parametrize("fmt", [F.NATIVE, F.YUV_PLANAR, F.Y])
def test_mesh_decode_formats(fmt):
    md = _port_mesh(space=2)
    blobs = _blobs()[:3]
    imgs = md.decode_batched([tapi.JpegStream(b) for b in blobs],
                             _tparams(fmt))
    _assert_same(_jax_mesh_decode(blobs, fmt, 2), imgs, md)
    # 3 images over 4 rows: one a row, the last row empty.
    assert [list(i) for _, i in md.last_paths] == [[0], [1], [2]]
    md.close()


def test_mesh_decode_crop():
    md = _port_mesh()
    crop = (16, 16, 16 + 64, 16 + 64)
    img = md.decode(tapi.JpegStream(_blobs()[0]), _tparams(F.RGB, crop))
    _assert_same(_jax_mesh_decode(_blobs()[:1], F.RGB, 1, crop), [img], md)
    md.close()


def test_mesh_mixed_shapes():
    """Each shape group is split on its own; a row decodes its shard of
    every group in one call."""
    md = _port_mesh(space=2)
    blobs = _mixed()
    imgs = md.decode_batched([tapi.JpegStream(b) for b in blobs],
                             _tparams(F.Y))
    _assert_same(_jax_mesh_decode(blobs, F.Y, 2), imgs, md)
    assert [list(i) for _, i in md.last_paths] == [[0], [3], [1], [2]]
    md.close()


def test_mesh_dri0_group_on_virtual_lanes():
    md = _port_mesh(space=4, entropy="on")
    blobs = _blobs(ri=0)
    imgs = md.decode_batched([tapi.JpegStream(b) for b in blobs],
                             _tparams(F.NATIVE))
    _assert_same(_jax_mesh_decode(blobs, F.NATIVE), imgs, md)
    assert [p for p, _ in md.last_paths] == ["wave-virtual"] * 2
    assert [list(i) for _, i in md.last_paths] == _contiguous(10, 2)
    md.close()


def test_mesh_matches_the_ports_own_decoder():
    """The mesh and one Decoder give the same bytes on both paths."""
    streams = [tapi.JpegStream(b) for b in _blobs()]
    want = tapi.Decoder(device="cpu").decode_batched(streams,
                                                     _tparams(F.NATIVE))
    md = _port_mesh(space=4, entropy="on")
    got = md.decode_batched(streams, _tparams(F.NATIVE))
    for a, b in zip(want, got):
        assert a.pitch == b.pitch
        for x, y in zip(a.channel, b.channel):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y)
    md.close()


# --- errors -------------------------------------------------------------------

def test_reference_mesh_decoder_drops_corrupt_flags():
    """Pins the JAX package's fault: its api.Decoder raises BAD_JPEG on one
    corrupt restart scan among 10, its MeshDecoder returns all 10 images
    with the flag set and unread."""
    blobs = _corrupt_batch()
    with pytest.raises(Exception) as ei:
        japi.Decoder().decode_batched([japi.JpegStream(b) for b in blobs])
    assert ei.value.status.name == "BAD_JPEG"
    md = jsharding.MeshDecoder(mesh=jmesh.make_mesh())
    imgs = md.decode_batched([japi.JpegStream(b) for b in blobs])
    assert len(imgs) == 10 and all(img is not None for img in imgs)
    assert any(np.asarray(e).any() for e in md.last_error_flags)


def test_port_mesh_raises_bad_jpeg_with_the_callers_index():
    md = _port_mesh(space=4, entropy="on")
    streams = [tapi.JpegStream(b) for b in _corrupt_batch()]
    with pytest.raises(RocJpegError) as ei:
        md.decode_batched(streams)
    assert ei.value.status == Status.BAD_JPEG
    assert f"[{CORRUPT}]" in str(ei.value)
    assert md.last_failed_indices() == [CORRUPT]
    # The same index as one Decoder over the whole batch.
    dec = tapi.Decoder(device="cpu", device_entropy="on", check_errors=False)
    dec.decode_batched(streams)
    assert dec.last_failed_indices() == [CORRUPT]
    md.close()


def test_port_mesh_without_check_returns_the_images():
    md = _port_mesh(space=4, entropy="on", check_errors=False)
    imgs = md.decode_batched([tapi.JpegStream(b) for b in _corrupt_batch()])
    assert len(imgs) == 10 and all(img is not None for img in imgs)
    assert md.last_failed_indices() == [CORRUPT]
    flags = md.last_error_flags
    assert len(flags) == 2  # one chunk a shard, 2 shards of 5
    assert [bool(f.any()) for f in flags] == [False, True]
    md.close()


def test_every_stream_is_checked_before_any_dispatch(monkeypatch):
    tiny = encoder.encode_planes(encoder.random_planes("420", 48, 32, 1),
                                 "420")
    md = _port_mesh()
    monkeypatch.setattr(md, "_decode_shard", lambda *a: pytest.fail(
        "a shard was dispatched"))
    for streams, status in (
            ([tapi.JpegStream(b) for b in _blobs()] + [tapi.JpegStream(tiny)],
             Status.JPEG_NOT_SUPPORTED),
            ([tapi.JpegStream(_blobs()[0]), None], Status.INVALID_PARAMETER)):
        with pytest.raises(RocJpegError) as ei:
            md.decode_batched(streams)
        assert ei.value.status == status


def test_first_shard_error_in_shard_order_after_every_shard_ends(
        monkeypatch):
    """Row 1 and row 3 fail; row 1's error is raised, and only after every
    shard has returned."""
    md = _port_mesh()
    done = []
    lock = threading.Lock()
    started = threading.Barrier(5, timeout=30)

    def fake(row, streams, params, caller_stream):
        started.wait()  # every shard is running before any returns
        with lock:
            done.append(row)
        if row == 1:
            raise RocJpegError(Status.EXECUTION_FAILED, "row 1")
        if row == 3:
            raise RocJpegError(Status.INTERNAL_ERROR, "row 3")
        return [None] * len(streams), [], []

    monkeypatch.setattr(md, "_decode_shard", fake)
    with pytest.raises(RocJpegError) as ei:
        md.decode_batched([tapi.JpegStream(b) for b in _blobs()])
    assert ei.value.status == Status.EXECUTION_FAILED
    assert sorted(done) == [0, 1, 2, 3, 4]
    assert md.last_paths == []
    md.close()


# --- meshes -------------------------------------------------------------------

def test_mesh_shape_and_axis_names_match_the_jax_package():
    import jax
    for space in (1, 2, 4, 8):
        jm = jmesh.make_mesh(space=space)
        tm = tmesh.make_mesh(devices=CPU8, space=space)
        assert dict(jm.shape) == tm.shape
        assert tuple(jm.axis_names) == tm.axis_names
    assert tmesh.make_mesh(4, devices=CPU8).shape == {"data": 4, "space": 1}
    with pytest.raises(ValueError):
        jmesh.make_mesh(devices=jax.devices()[:6], space=4)
    with pytest.raises(ValueError):
        tmesh.make_mesh(devices=["cpu"] * 6, space=4)


def test_mesh_without_cuda_is_not_initialized(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (tmesh.make_mesh, tsharding.MeshDecoder,
                 lambda: tmesh.make_mesh(devices=["cuda:0"])):
        with pytest.raises(RocJpegError) as ei:
            make()
        assert ei.value.status == Status.NOT_INITIALIZED


def test_mesh_with_an_absent_card_is_not_initialized(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RocJpegError) as ei:
        tmesh.make_mesh(devices=["cuda:0", "cuda:1"])
    assert ei.value.status == Status.NOT_INITIALIZED


# --- decode_batched_local -----------------------------------------------------

@pytest.mark.parametrize("fmt", [F.RGB, F.NATIVE])
def test_decode_batched_local_matches_the_jax_package(fmt):
    blobs = _blobs()
    jmd = jsharding.MeshDecoder(mesh=jmesh.make_mesh())
    jimgs, jpitches, jerr = jmd.decode_batched_local(
        [japi.JpegStream(b) for b in blobs], _jparams(fmt),
        global_arrays=False)
    md = _port_mesh()
    imgs, pitches, err = md.decode_batched_local(
        [tapi.JpegStream(b) for b in blobs], _tparams(fmt))
    assert list(pitches) == list(jpitches)
    assert len(imgs) == len(jimgs) == 10
    for a, b in zip(jimgs, imgs):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert isinstance(y, np.ndarray)
            np.testing.assert_array_equal(y, x)
    assert not np.asarray(jerr).any()
    assert err.dtype == bool and err.shape == (10,) and not err.any()
    md.close()


def test_decode_batched_local_flags_images():
    md = _port_mesh(space=4, entropy="on")
    _, _, err = md.decode_batched_local(
        [tapi.JpegStream(b) for b in _corrupt_batch()])
    assert np.nonzero(err)[0].tolist() == [CORRUPT]
    md.close()


def test_decode_batched_local_refusals():
    md = _port_mesh()
    for global_arrays in (False, True):
        with pytest.raises(RocJpegError) as ei:
            md.decode_batched_local([tapi.JpegStream(b) for b in _mixed()],
                                    global_arrays=global_arrays)
        assert ei.value.status == Status.INVALID_PARAMETER


@pytest.mark.parametrize("fmt", [F.RGB, F.NATIVE])
def test_decode_batched_local_global_arrays_matches_the_jax_package(fmt):
    """In one process the JAX package's ``global_arrays=True`` is its
    process-local call (``rocjpeg_tpu/dist/sharding.py:267``); the port's
    gives the same images, pitches and flags, and the same as its own
    ``global_arrays=False``."""
    blobs = _blobs()
    jmd = jsharding.MeshDecoder(mesh=jmesh.make_mesh())
    jimgs, jpitches, jerr = jmd.decode_batched_local(
        [japi.JpegStream(b) for b in blobs], _jparams(fmt),
        global_arrays=True)
    md = _port_mesh()
    streams = [tapi.JpegStream(b) for b in blobs]
    imgs, pitches, err = md.decode_batched_local(streams, _tparams(fmt),
                                                 global_arrays=True)
    local, local_pitches, local_err = md.decode_batched_local(
        streams, _tparams(fmt), global_arrays=False)
    assert list(pitches) == list(jpitches) == list(local_pitches)
    assert len(imgs) == len(jimgs) == len(local) == 10
    for a, b, c in zip(jimgs, imgs, local):
        assert len(a) == len(b) == len(c)
        for x, y, z in zip(a, b, c):
            assert isinstance(y, np.ndarray)
            np.testing.assert_array_equal(y, x)
            np.testing.assert_array_equal(z, y)
    assert not np.asarray(jerr).any()
    assert err.shape == (10,) and not err.any() and not local_err.any()
    md.close()


# --- the space axis: K2 in bands on the host-entropy path --------------------

@functools.lru_cache(maxsize=None)
def _frames(css, w, h, n=5):
    """``n`` restart-free frames: under 'auto' a few small ones take the
    host path, as under 'off'."""
    return tuple(encoder.encode_planes(
        encoder.random_planes(css, w, h, seed=s), css) for s in range(n))


def _record_k2(monkeypatch):
    """Wrap ``kernels.transform.transform``: each call's (device, plane
    dims) in a list, in call order (the rows' threads take a lock)."""
    calls, lock = [], threading.Lock()
    real = transform.transform

    def wrapped(coeffs, quant, geom, *args):
        with lock:
            calls.append((coeffs.device, geom.comp_dims()))
        return real(coeffs, quant, geom, *args)

    monkeypatch.setattr(transform, "transform", wrapped)
    return calls


def _bands(blob, space):
    """The K2 launches one chunk should make: per band, the plane dims of
    the components it holds. A component whose block rows ``space``
    divides is cut into ``space`` bands; another goes whole into band 0
    (the JAX package's ``P("data", "space")`` rule)."""
    p = tapi.JpegStream(blob).params
    bands = [[] for _ in range(space)]
    for c in range(p.num_components):
        bh, bw = p.component_block_dims(c)
        if bh % space == 0:
            for band in bands:
                band.append((bh // space, bw))
        else:
            bands[0].append((bh, bw))
    return [tuple(b) for b in bands if b]


def _space_case(monkeypatch, blobs, fmt, space, entropy="off", crop=None):
    """The port's mesh over 8 CPU devices at ``space`` against the JAX
    package's at the same ``space`` (bytes and pitches, tolerance 0) and
    against the port's own mesh of as many rows at ``space=1`` (bytes,
    ``last_paths``, ``last_failed_indices()``); K2 runs once a band of
    each host chunk, on the band's device, with the band's dims."""
    calls = _record_k2(monkeypatch)
    md = _port_mesh(space, entropy)
    streams = [tapi.JpegStream(b) for b in blobs]
    imgs = md.decode_batched(streams, _tparams(fmt, crop))
    _assert_same(_jax_mesh_decode(blobs, fmt, space, crop, entropy), imgs,
                 md)
    rows = 8 // space
    assert [list(i) for _, i in md.last_paths] == _contiguous(len(blobs),
                                                              rows)
    assert {p for p, _ in md.last_paths} == {"host"}
    bands = _bands(blobs[0], space)
    assert len(calls) == len(bands) * len(md.last_paths)
    assert sorted(dims for _, dims in calls) == sorted(
        bands * len(md.last_paths))
    assert all(dev == torch.device("cpu") for dev, _ in calls)
    one = tsharding.MeshDecoder(tmesh.make_mesh(devices=["cpu"] * rows),
                                device_entropy=entropy)
    want = one.decode_batched(streams, _tparams(fmt, crop))
    assert one.last_paths == md.last_paths
    assert one.last_failed_indices() == md.last_failed_indices() == []
    for a, b in zip(want, imgs):
        assert a.pitch == b.pitch
        for x, y in zip(a.channel, b.channel):
            assert (x is None) == (y is None)
            assert x is None or torch.equal(x, y)
    md.close()
    one.close()


SPACE_FORMATS = ([("420", 128, 96, fmt) for fmt in F]
                 + [(css, 64, 64, fmt) for css in ("422", "444", "400")
                    for fmt in (F.RGB, F.NATIVE)])


@pytest.mark.parametrize("space", [2, 4])
@pytest.mark.parametrize("css, w, h, fmt", SPACE_FORMATS,
                         ids=lambda v: getattr(v, "name", str(v)))
def test_space_bands_match_the_jax_package(monkeypatch, space, css, w, h,
                                           fmt):
    _space_case(monkeypatch, _frames(css, w, h), fmt, space)


@pytest.mark.parametrize("space", [2, 4])
def test_space_bands_with_a_crop(monkeypatch, space):
    _space_case(monkeypatch, _frames("420", 128, 96), F.RGB, space,
                crop=(8, 24, 8 + 96, 24 + 48))


@pytest.mark.parametrize("space, h", [(2, 80), (4, 96)])
@pytest.mark.parametrize("fmt", [F.NATIVE, F.RGB])
def test_space_luma_band_ends_mid_mcu(monkeypatch, space, h, fmt):
    """3840x2160 4:2:0 at space 2 in small: luma's block rows divide by
    ``space``, chroma's do not, so each luma band ends halfway through an
    MCU row and chroma runs whole in band 0."""
    blobs = _frames("420", 128, h)
    bands = _bands(blobs[0], space)
    assert bands[0][1:] == ((h // 16, 8),) * 2 and (h // 16) % space
    assert bands[1:] == [((h // 8 // space, 16),)] * (space - 1)
    assert (h // 8 // space) % 2 == 1  # a band of an odd block-row count
    _space_case(monkeypatch, blobs, fmt, space)


@pytest.mark.parametrize("space", [2, 4])
def test_space_bands_under_auto(monkeypatch, space):
    """A group of three small restart-free frames has too few lanes for
    the wave: 'auto' takes the host path, in bands, in both packages."""
    _space_case(monkeypatch, _frames("420", 128, 96, n=3), F.NATIVE, space,
                entropy="auto")


def test_space_bands_report_a_corrupt_scan_as_space_one(monkeypatch):
    """A corrupt restart-free scan on the host path: the same outcome at
    space 2 as at space 1 (status, or the same bytes)."""
    blobs = list(_frames("420", 128, 96))
    blobs[3] = _garbled(blobs[3])
    streams = [tapi.JpegStream(b) for b in blobs]
    outcomes = []
    for space in (1, 2):
        md = tsharding.MeshDecoder(
            tmesh.make_mesh(devices=["cpu"] * (4 * space), space=space),
            device_entropy="off")
        try:
            imgs = md.decode_batched(streams, _tparams(F.RGB))
            outcomes.append([img.channel[0].numpy() for img in imgs])
        except RocJpegError as exc:
            outcomes.append(exc.status)
        md.close()
    if isinstance(outcomes[0], Status):
        assert outcomes[1] == outcomes[0]
    else:
        for a, b in zip(*outcomes):
            np.testing.assert_array_equal(a, b)


# --- the kernel wrappers' device guard ----------------------------------------

@pytest.mark.parametrize("module, call, tensor", [
    (wave, "rjt_wave_decode", "dense"),
    (transform, "rjt_transform", "dev"),
    (epilogue, "_render_kernel", "y")])
def test_kernel_launches_run_under_their_tensors_device(module, call,
                                                        tensor):
    """Each ctypes launch site sits inside ``with
    torch.cuda.device(<its input tensor's device>)``, so the stream it
    takes and the device the library reads are the tensors' card, not the
    calling thread's current one. (A launch itself needs the card.)"""
    with open(module.__file__) as f:
        tree = ast.parse(f.read())
    parents = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    sites = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and (getattr(n.func, "attr", None) == call
                  or getattr(n.func, "id", None) == call)]
    assert sites
    for site in sites:
        node, guards = site, []
        while node in parents:
            node = parents[node]
            if isinstance(node, ast.With):
                guards += [ast.unparse(item.context_expr)
                           for item in node.items]
        assert any(g in (f"torch.cuda.device({tensor})",
                         f"torch.cuda.device({tensor}.device)")
                   for g in guards), (call, guards)
        assert "torch.cuda.current_stream()" in ast.unparse(site)
