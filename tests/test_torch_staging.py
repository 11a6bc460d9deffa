"""The port's host staging layer (``rocjpeg_tpu_torch.ops.staging``) on the
CPU.

Pool semantics with a stub event that stays pending until it is set: an
acquire waits, and no buffer is handed out while its copy is pending; the
byte bound, least-recently-used eviction (a buffer evicted mid-copy is freed
only after its event) and bucket reuse; one packer pool for every decoder
and thread; the walk-buffer pool; typed errors for wrong dtypes; the
staged layout. Then dirty buffers: every fresh staging and walk buffer is
filled with 0xA5 by a monkeypatch of the allocator, and the packers' arrays
must equal those packed into zeroed buffers byte for byte, while restart,
DRI=0, ROI crops on both paths, 5 table banks (the host fallback), the
fuzz blobs and the soak's first batches decode as the JAX package decodes
them: the same bytes, ``Status`` names and ``last_failed_indices()``.
"""

import ast
import concurrent.futures
import functools
import inspect
import random
import sys
import threading
import time

import numpy as np
import pytest
import torch

from rocjpeg_tpu import api as japi
from rocjpeg_tpu import types as jtypes
from rocjpeg_tpu.status import RocJpegError as JaxRocJpegError
from rocjpeg_tpu_torch import api as tapi
from rocjpeg_tpu_torch import pipeline
from rocjpeg_tpu_torch import types as ttypes
from rocjpeg_tpu_torch.core.bitstream import JpegStreamParser
from rocjpeg_tpu_torch.ops import pack, staging, tables
from rocjpeg_tpu_torch.runtime import native
from rocjpeg_tpu_torch.status import RocJpegError, Status
from rocjpeg_tpu_torch.testing import encoder, hostile
from rocjpeg_tpu_torch.types import OutputFormat
from test_torch_banked import _blobs as banked_blobs
from test_torch_jaxlib import jax_native  # noqa: F401  (autouse)

F = OutputFormat
K = 1 << 16  # the staging pool's capacity quantum


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """K1's plain version steps over small tensors: torch's intra-op pool
    only spins there, against the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StubEvent:
    """A copy's event that completes when the test sets it."""

    def __init__(self, done=False):
        self._done = threading.Event()
        if done:
            self._done.set()

    def query(self):
        return self._done.is_set()

    def synchronize(self):
        assert self._done.wait(10), "stub event never set"

    def set(self):
        self._done.set()


# --- the staging pool ---------------------------------------------------------

def test_acquire_waits_for_the_oldest_pending_copy():
    pool = staging.StagingPool(depth=2)
    a, b = pool.acquire(1000), pool.acquire(1000)
    assert a is not b and pool.stats()["allocations"] == 2
    ev_a, ev_b = StubEvent(), StubEvent()
    pool.release(a, ev_a)
    pool.release(b, ev_b)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(pool.acquire, 1000)
        time.sleep(0.2)
        assert not fut.done()  # both copies pending, the size's depth used
        ev_b.set()
        time.sleep(0.2)
        assert not fut.done()  # it waits on the oldest copy's event
        ev_a.set()
        got = fut.result(timeout=10)
    assert got is a
    assert pool.stats()["waits"] == 1
    assert pool.stats()["allocations"] == 2


def test_a_completed_buffer_goes_before_a_pending_one():
    pool = staging.StagingPool()
    a, b = pool.acquire(1000), pool.acquire(1000)
    pool.release(a, StubEvent())
    pool.release(b, StubEvent(done=True))
    assert pool.acquire(1000) is b
    # Below the depth a pending buffer is never waited on: a new one comes.
    c = pool.acquire(1000)
    assert c is not a and pool.stats()["waits"] == 0
    assert pool.stats()["allocations"] == 3


def test_no_buffer_while_all_of_its_size_are_out():
    pool = staging.StagingPool(depth=1)
    a = pool.acquire(1000)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(pool.acquire, 1000)
        time.sleep(0.2)
        assert not fut.done()
        pool.release(a, None)
        assert fut.result(timeout=10) is a


def test_buckets_reuse_and_differ():
    pool = staging.StagingPool()
    a = pool.acquire(K - 5)
    assert a.host.nbytes == K
    pool.release(a)
    assert pool.acquire(K) is a  # same bucket
    b = pool.acquire(K + 1)
    assert b is not a and b.host.nbytes == 2 * K
    assert staging.bucket_fine(9 * K + 1, K) == 10 * K  # 1/8 steps past 8 K
    assert pool.stats()["allocations"] == 2


def test_bound_evicts_idle_buffers_least_recent_first(monkeypatch):
    freed = []
    monkeypatch.setattr(staging, "_free_host", freed.append)
    pool = staging.StagingPool(max_bytes=3 * K)
    a, b = pool.acquire(K), pool.acquire(2 * K)
    pool.release(a)
    pool.release(b)
    assert pool.stats()["held_bytes"] == 3 * K
    c = pool.acquire(K)  # reuses a: nothing evicted
    assert c is a and not freed
    pool.release(c)
    d = pool.acquire(4 * K)  # past the bound: b went back first, then a
    assert freed == [b, a]
    assert pool.stats()["held_bytes"] == 4 * K  # over the bound while out
    pool.release(d)  # at rest the pool keeps to its bound
    assert freed == [b, a, d] and pool.stats()["held_bytes"] == 0


def test_an_evicted_buffer_is_freed_after_its_copy(monkeypatch):
    freed = []
    monkeypatch.setattr(staging, "_free_host", freed.append)
    pool = staging.StagingPool(max_bytes=2 * K)
    a = pool.acquire(K)
    ev = StubEvent()
    pool.release(a, ev)
    b = pool.acquire(2 * K)  # evicts a, whose copy is still pending
    assert not freed and pool.stats()["retired"] == 1
    assert pool.stats()["held_bytes"] == 3 * K
    ev.set()
    pool.release(b)
    assert freed == [a] and pool.stats()["retired"] == 0
    assert pool.stats()["held_bytes"] == 2 * K


class TimedEvent:
    """A copy's event that completes at a set time."""

    def __init__(self, seconds):
        self._at = time.monotonic() + seconds

    def query(self):
        return time.monotonic() >= self._at

    def synchronize(self):
        time.sleep(max(0.0, self._at - time.monotonic()))


def test_pool_stress_never_hands_out_a_pending_or_used_buffer():
    """More threads than cores, a short switch interval: a buffer is never
    out twice at once, and never out while its last copy is pending."""
    pool = staging.StagingPool(depth=3)
    out, last, lock = set(), {}, threading.Lock()
    errors = []
    deadline = time.monotonic() + 3

    def worker(seed):
        rng = random.Random(seed)
        while time.monotonic() < deadline:
            buf = pool.acquire(rng.choice((1000, 70000)))
            with lock:
                ev = last.get(id(buf))
                if id(buf) in out or (ev is not None and not ev.query()):
                    errors.append(buf)
                out.add(id(buf))
            time.sleep(rng.random() * 1e-4)
            ev = TimedEvent(rng.random() * 2e-3)
            with lock:
                out.discard(id(buf))
                last[id(buf)] = ev
            pool.release(buf, ev)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    stats = pool.stats()
    assert stats["allocations"] <= 2 * 3  # two sizes, depth 3 each
    assert stats["waits"] > 0 and stats["reuses"] > 0


# --- one packer pool ----------------------------------------------------------

def test_one_packer_pool_for_every_decoder_and_thread(monkeypatch):
    blobs = _streams("420", 2)
    pool = staging.pack_pool()
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        assert set(ex.map(lambda _: staging.pack_pool(), range(4))) == {pool}
    made, threads = [], set()
    real_init = concurrent.futures.ThreadPoolExecutor.__init__
    real_pack = native.pack_dense

    def spy_init(self, *a, **kw):
        made.append(self)
        real_init(self, *a, **kw)

    def spy_pack(*a, **kw):
        threads.add(threading.current_thread().name)
        return real_pack(*a, **kw)

    decoders = [tapi.Decoder(device="cpu", device_entropy="on")
                for _ in range(2)]
    streams = [tapi.JpegStream(b) for b in blobs]
    with concurrent.futures.ThreadPoolExecutor(2) as callers:
        monkeypatch.setattr(concurrent.futures.ThreadPoolExecutor,
                            "__init__", spy_init)
        monkeypatch.setattr(native, "pack_dense", spy_pack)
        outs = list(callers.map(lambda d: d.decode_batched(streams),
                                decoders))
    assert not made  # no pool is built per call
    assert threads and all(n.startswith("rjt-pack") for n in threads)
    for a, b in zip(*outs):
        assert torch.equal(a.channel[0], b.channel[0])


# --- the walk's buffer sets ---------------------------------------------------

def test_walk_sets_grow_and_are_reused():
    """A free set is reused by an acquire of as many streams or fewer; a
    wider acquire gets one new slab and the narrower set is dropped."""
    pool = staging.IdxBufPool()
    tok, small = pool.acquire(2, 1000, 10)
    pool.release(tok)
    tok, big = pool.acquire(4, 1000, 10)
    assert len(big) == 4 and not any(
        np.shares_memory(x[0], y[0]) for x in small for y in big)
    assert len({id(b[0].base) for b in big}) == 1  # one slab
    pool.release(tok)
    assert pool.free_sets() == 1  # the narrower set was dropped
    tok, again = pool.acquire(4, 1000, 10)
    assert all(x is y for x, y in zip(big, again))
    pool.release(tok)
    tok, fewer = pool.acquire(3, 1000, 10)
    assert len(fewer) == 3 and all(x is y for x, y in zip(big, fewer))
    pool.release(tok)
    tok, wider = pool.acquire(1, K + 1, 10)  # another capacity bucket
    clean, bit_off, dc, mi, sc = wider[0]
    assert clean.nbytes == 2 * K and dc.shape == (256, 3)
    assert (bit_off.dtype, mi.dtype, sc.dtype) == (np.int64, np.int32,
                                                   np.int32)
    assert wider[0] is not again[0]


def _dri0_params(n=2, w=64, h=48, css="420"):
    return [JpegStreamParser().parse(encoder.encode_planes(
        encoder.random_planes(css, w, h, seed=s), css, restart_interval=0))
        for s in range(n)]


WALKERS = {"index_scan": 1, "index_scan2": 2, "index_scan8": 8,
           "index_scan16": 16}


@pytest.mark.parametrize("walker", list(WALKERS))
def test_walkers_on_dirty_pooled_sets_equal_fresh_ones(walker):
    """Every walker writes the same records and clean stream (its 8 bytes
    of slack zeroed) into sets filled with 0xA5 as into fresh ones."""
    n = WALKERS[walker]
    plist = (_dri0_params(n) if n < 8 else _dri0_params(2) * (n // 2))
    caps = [native.index_job_capacities(p, 60) for p in plist]
    _tok, sets = staging.IdxBufPool().acquire(
        n, max(c[0] for c in caps), max(c[1] for c in caps))
    for got in sets:
        for a in got:
            a.view(np.uint8).fill(0xA5)
    fn = getattr(native, walker)
    if n == 1:
        fresh, dirty = [fn(plist[0], 60)], [fn(plist[0], 60, sets[0])]
    elif n == 2:
        fresh, dirty = fn(*plist, 60), fn(*plist, 60, sets)
    else:
        fresh, dirty = fn(plist, 60), fn(plist, 60, sets)
    if fresh is None:  # this host lacks the SIMD tier
        assert dirty is None
        return
    for (clean, *recs), (dclean, *drecs), got in zip(fresh, dirty, sets):
        np.testing.assert_array_equal(clean, dclean)
        assert np.shares_memory(dclean, got[0])
        assert not got[0][len(dclean):len(dclean) + 8].any()
        for a, b in zip(recs, drecs):
            np.testing.assert_array_equal(a, b)


def test_walk_sets_are_dropped_on_an_exception(monkeypatch):
    monkeypatch.setattr(staging, "_walk_pool", staging.IdxBufPool())
    good = _dri0_params()
    tb = tables.GroupGeometry.from_params(good[0], 2).total_blocks
    ref = pack.pack_virtual_segments(good, tb, 60)
    assert staging.walk_buffer_pool().free_sets() == 1
    bad = _dri0_params()
    data = bytearray(bad[1].slice_data)
    data[len(data) // 2:len(data) // 2 + 2] = b"\xff\xd3"  # a real RSTn
    bad[1].slice_data = bytes(data)
    with pytest.raises(RocJpegError) as ei:
        pack.pack_virtual_segments(bad, tb, 60)
    assert ei.value.status == Status.BAD_JPEG
    assert staging.walk_buffer_pool().free_sets() == 0
    again = pack.pack_virtual_segments(good, tb, 60)
    for x, y in zip(_arrays(*ref), _arrays(*again)):
        np.testing.assert_array_equal(x, y)


# --- typed errors and the layout ---------------------------------------------

def test_wrong_dtypes_raise_invalid_parameter():
    st = staging.Stager("cpu", pool=staging.StagingPool())
    with pytest.raises(RocJpegError) as ei:
        st.reserve("x", (4,), np.float32)
    assert ei.value.status == Status.INVALID_PARAMETER
    st.reserve("a", (4,), np.int32)
    st.open()
    for bad in (np.zeros(4, np.int64), np.zeros(4, np.uint32),
                np.zeros(5, np.int32), [0, 0, 0, 0]):
        with pytest.raises(RocJpegError) as ei:
            st.put("a", bad)
        assert ei.value.status == Status.INVALID_PARAMETER
    p = _dri0_params(1)[0]
    cb, nr = native.index_job_capacities(p, 60)
    bufs = [np.zeros(cb, np.uint8), np.zeros(nr, np.int32),
            np.zeros((nr, 3), np.int32), np.zeros(nr, np.int32),
            np.zeros(nr, np.int32)]  # bit_off must be int64
    with pytest.raises(RocJpegError) as ei:
        native.index_scan(p, 60, bufs)
    assert ei.value.status == Status.INVALID_PARAMETER
    with pytest.raises(RocJpegError) as ei:
        pipeline.decode_group([p], [[np.zeros((6, 8, 64), np.int32)] * 3],
                              F.RGB, "cpu")
    assert ei.value.status == Status.INVALID_PARAMETER


def test_staged_arrays_share_one_copy_at_256_byte_offsets():
    pool = staging.StagingPool()
    arrays = {"a": np.arange(7, dtype=np.int32),
              "b": np.arange(12, dtype=np.uint32).reshape(3, 4) << 20,
              "c": np.arange(-5, 5, dtype=np.int16)}
    with staging.Stager("cpu", pool=pool) as st:
        for name, a in arrays.items():
            st.reserve(name, a.shape, a.dtype)
        st.open()
        for name, a in arrays.items():
            st.put(name, a)
        dev = st.upload()
    base = dev["a"].untyped_storage().data_ptr()
    assert len({t.untyped_storage().data_ptr() for t in dev.values()}) == 1
    for name, a in arrays.items():
        t = dev[name]
        assert (t.data_ptr() - base) % staging.ALIGN == 0
        assert t.shape == a.shape
        np.testing.assert_array_equal(t.numpy().view(a.dtype), a)
    assert pool.stats()["idle"] == 1  # back in the pool after the copy


def test_upload_copy_and_event_run_under_the_stagers_device():
    """The copy, the stream and the event of ``Stager.upload`` sit inside
    ``with torch.cuda.device(self.device)`` (a CUDA upload needs the
    card)."""
    tree = ast.parse(inspect.getsource(staging.Stager.upload).lstrip()
                     .replace("\n    ", "\n"))
    guarded = [w for w in ast.walk(tree) if isinstance(w, ast.With)
               and any(ast.unparse(i.context_expr)
                       == "torch.cuda.device(self.device)" for i in w.items)]
    assert len(guarded) == 1
    inside = ast.unparse(guarded[0])
    for call in ("current_stream(self.device)", "copy_(host, non_blocking=True)",
                 "event.record(stream)", "is_pinned()"):
        assert call in inside, call


# --- dirty buffers ------------------------------------------------------------

def _fill_alloc(monkeypatch, byte):
    """Every fresh staging and walk buffer filled with ``byte``, in fresh
    process pools. Returns the list of allocations made."""
    real = staging._alloc_host
    made = []

    def alloc(nbytes, pinned):
        buf = real(nbytes, pinned)
        buf.fill(byte)
        made.append(nbytes)
        return buf

    monkeypatch.setattr(staging, "_alloc_host", alloc)
    monkeypatch.setattr(staging, "_staging_pool", staging.StagingPool())
    monkeypatch.setattr(staging, "_walk_pool", staging.IdxBufPool())
    return made


@pytest.fixture
def dirty(monkeypatch):
    return _fill_alloc(monkeypatch, 0xA5)


def _arrays(packed, dc_flat=None, lane_of_mcu=None):
    out = [packed.dense, packed.word_off, packed.img_base, packed.mcu_start,
           packed.mcu_count, packed.lane_bank]
    return out + [a for a in (dc_flat, lane_of_mcu) if a is not None]


def _streams(css, ri, n=3, w=64, h=64):
    return [encoder.encode_planes(encoder.random_planes(css, w, h, seed=s),
                                  css, restart_interval=ri)
            for s in range(n)]


PACK_CASES = [("restart", 2, None), ("restart-roi", 2, (4, 12)),
              ("virtual", 0, None), ("virtual-roi", 0, (5, 11))]


@pytest.mark.parametrize("name,ri,mcu_range", PACK_CASES,
                         ids=[c[0] for c in PACK_CASES])
def test_dirty_packs_equal_zeroed_ones(monkeypatch, name, ri, mcu_range):
    """Every array the device reads, at its full length: the same bytes
    from buffers filled with 0xA5 as from zeroed ones, through the packer
    and through ``pipeline.pack_group``'s one staged upload."""
    plist = [JpegStreamParser().parse(b) for b in _streams("420", ri)]
    tb = tables.GroupGeometry.from_params(plist[0], 3).total_blocks
    crop = (None if mcu_range is None
            else ttypes.CropRectangle(0, 16, 64, 48))
    outs = []
    for byte in (0x00, 0xA5):
        with monkeypatch.context() as m:
            _fill_alloc(m, byte)
            if ri:
                got = (pack.pack_segments(plist, tb, mcu_range=mcu_range),)
            else:
                got = pack.pack_virtual_segments(plist, tb, 60,
                                                 mcu_range=mcu_range)
            g = pipeline.pack_group(plist, "cpu", crop,
                                    virtual_k=None if ri else 60)
            dp = g.packed
            tensors = [dp.dense, dp.word_off, dp.img_base, dp.mcu_start,
                       dp.mcu_count, dp.lane_bank, dp.dc_flat,
                       dp.lane_of_mcu, g.lentab, g.values, g.quant]
            outs.append(([a.copy() for a in _arrays(*got)],
                         [None if t is None else t.clone() for t in tensors],
                         g.max_steps, g.lane_img))
    (a0, t0, s0, l0), (a1, t1, s1, l1) = outs
    for x, y in zip(a0, a1):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    for x, y in zip(t0, t1):
        assert (x is None) == (y is None)
        assert x is None or torch.equal(x, y)
    assert s0 == s1
    np.testing.assert_array_equal(l0, l1)


@functools.lru_cache(maxsize=None)
def _sides(entropy="on", check=False):
    return ((japi, JaxRocJpegError,
             japi.Decoder(device_entropy=entropy, check_errors=check)),
            (tapi, RocJpegError,
             tapi.Decoder(device="cpu", device_entropy=entropy,
                          check_errors=check)))


def _batch_outcome(side, blobs, fmt, crop=None):
    """("error", status name), or ("decoded", paths, failed indices,
    per-image channel bytes and pitches, None for a flagged image)."""
    mod, error, dec = side
    types = jtypes if mod is japi else ttypes
    kwargs = {}
    if crop is not None:
        kwargs["crop_rectangle"] = types.CropRectangle(*crop)
    params = types.DecodeParams(types.OutputFormat(int(fmt)), **kwargs)
    try:
        imgs = dec.decode_batched([mod.JpegStream(b) for b in blobs], params)
    except error as exc:
        return ("error", exc.status.name)
    failed = dec.last_failed_indices()
    return ("decoded", [p for p, _ in dec.last_paths], failed,
            [None if i in failed else
             [(None if c is None else c.tobytes(), p)
              for c, p in zip(hostile.host_channels(img), img.pitch)]
             for i, img in enumerate(imgs)])


MAIN_CASES = {
    "restart-rgb": (lambda: _streams("420", 2), F.RGB, None, "wave"),
    "restart-native": (lambda: _streams("422", 2), F.NATIVE, None, "wave"),
    "dri0-rgb": (lambda: _streams("420", 0), F.RGB, None, "wave-virtual"),
    "restart-roi": (lambda: _streams("420", 2), F.RGB, (8, 16, 56, 40),
                    "wave"),
    "dri0-roi": (lambda: _streams("420", 0), F.NATIVE, (8, 16, 56, 40),
                 "wave-virtual"),
    "banks5-host": (lambda: banked_blobs(5, 4), F.RGB, None, "host"),
}


@pytest.mark.parametrize("case", list(MAIN_CASES))
def test_dirty_main_path_as_the_jax_package(dirty, case):
    make, fmt, crop, path = MAIN_CASES[case]
    blobs = make()
    jax_side, port_side = _sides()
    mine = _batch_outcome(port_side, blobs, fmt, crop)
    assert dirty, "no buffer was allocated dirty"
    assert mine[0] == "decoded" and set(mine[1]) == {path}
    assert mine == _batch_outcome(jax_side, blobs, fmt, crop)


FUZZ = [(kind, k) for kind, n in (("trunc", hostile.N_CUTS),
                                  ("bitflip", hostile.N_FLIPS),
                                  ("garbage", hostile.N_GARBAGE))
        for k in range(n)]


@pytest.fixture(scope="module")
def fuzz_blobs():
    by_kind = {}
    for kind, blob in hostile.fuzz_blobs():
        by_kind.setdefault(kind, []).append(blob)
    return by_kind


@pytest.mark.parametrize("kind,k", FUZZ, ids=[f"{a}{b}" for a, b in FUZZ])
def test_dirty_fuzz_blob_as_the_jax_package(dirty, fuzz_blobs, kind, k):
    blob = fuzz_blobs[kind][k]
    jax_side, port_side = _sides("on", False)
    assert (hostile.outcome(port_side, blob, F.RGB)
            == hostile.outcome(jax_side, blob, F.RGB))


@pytest.mark.parametrize("i", range(3))
def test_dirty_soak_batch_as_the_jax_package(dirty, i):
    from rocjpeg_tpu.core import golden as jgolden
    fmt, entropy, batch = hostile.soak_batch(i)
    jax_side, port_side = _sides(entropy, False)
    stats = hostile.new_stats()
    hostile.check_batch(
        batch, fmt, port_side, jax_side,
        lambda blob, f: jgolden.decode(blob, jtypes.OutputFormat(int(f))),
        stats)
    assert stats["batches"] + stats["mutated_typed_error"] > 0
