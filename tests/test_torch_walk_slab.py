"""The index walk's buffer sets as one slab each, on the CPU.

The AVX-512 walkers (``rjt_index_scan16`` and ``rjt_index_scan32``) address
every clean stream of a chunk by a 32-bit offset from the lowest one and
refuse a chunk whose streams lie further apart. Buffers of separate
allocations may: once a freed large array has raised glibc's dynamic mmap
threshold, some come from the heap and some from mappings terabytes away.
``ops.staging.IdxBufPool`` therefore lays a set's clean streams out in one
slab. These cases take every acquire path after that allocation history
and hold the slab's layout, the wide walkers' records (against the
single-stream walker) and the packer's walker counts and arrays (against
the JAX package's ``pack_virtual_segments``). Every case skips on a host
without AVX-512.
"""

import itertools

import numpy as np
import pytest

from rocjpeg_tpu.core.bitstream import JpegStreamParser as JaxParser
from rocjpeg_tpu.ops import device_entropy as de
from rocjpeg_tpu_torch import convert
from rocjpeg_tpu_torch.core.bitstream import JpegStreamParser
from rocjpeg_tpu_torch.ops import pack, staging, tables
from rocjpeg_tpu_torch.runtime import native
from rocjpeg_tpu_torch.testing import encoder
from test_torch_jaxlib import jax_native  # noqa: F401  (autouse)
from test_torch_wave import _assert_prefix_equal


@pytest.fixture(autouse=True)
def _avx512():
    if not native.index_scan16_available():
        pytest.skip("the AVX-512 walkers need a host with AVX-512")


BIG = 2 << 20  # clean bytes a stream: above glibc's default mmap threshold
N_REC = 2000
VSYMS = 60


def _raise_mmap_threshold(pool, clean_bytes=BIG, n_rec=N_REC):
    """The allocation history that spread the walk's sets: 8 streams
    acquired and released, then a 4 MiB array freed, which raises glibc's
    dynamic mmap threshold past the next buffers' size."""
    token, _bufs = pool.acquire(8, clean_bytes, n_rec)
    pool.release(token)
    freed = np.ones(4 << 20, np.uint8)
    del freed


def _sets(path, width):
    """The pool's buffer sets of ``width`` streams by acquire path, after
    :func:`_raise_mmap_threshold`: a fresh pool, a set released and taken
    again, a narrower set grown, and a set of another capacity bucket."""
    pool = staging.IdxBufPool()
    _raise_mmap_threshold(pool)
    if path == "fresh":
        pool = staging.IdxBufPool()
    elif path == "reused":
        token, _bufs = pool.acquire(width, BIG, N_REC)
        pool.release(token)
    _token, bufs = pool.acquire(
        width, 3 * BIG if path == "other-bucket" else BIG, N_REC)
    return bufs


PATHS = ("fresh", "reused", "grown", "other-bucket")


@pytest.mark.parametrize("path,width",
                         list(itertools.product(PATHS, (8, 16, 32))))
def test_every_acquire_path_gives_one_slab(path, width):
    bufs = _sets(path, width)
    assert len(bufs) == width
    cleans = [b[0] for b in bufs]
    slab = cleans[0].base
    assert slab is not None and all(c.base is slab for c in cleans)
    lo, hi = slab.ctypes.data, slab.ctypes.data + slab.nbytes
    starts = [c.ctypes.data for c in cleans]
    for c, start in zip(cleans, starts):
        assert start % staging.SLAB_ALIGN == 0
        assert lo <= start and start + c.nbytes + staging.WALK_SLACK <= hi
    assert not any(np.shares_memory(a, b)
                   for a, b in itertools.combinations(cleans, 2))
    span = max(s + c.nbytes for s, c in zip(starts, cleans)) - min(starts)
    assert span + staging.WALK_SLACK <= staging.SLAB_SPAN_LIMIT


def _dri0_params(n, variants=None, w=64, h=48):
    return [JpegStreamParser().parse(encoder.encode_planes(
        encoder.random_planes("420", w, h, seed=s), "420",
        restart_interval=0,
        table_variant=variants[s] if variants else 0)) for s in range(n)]


@pytest.mark.parametrize("path,width",
                         list(itertools.product(PATHS, (16, 32))))
def test_wide_walkers_take_the_pools_sets(path, width):
    plist = _dri0_params(width)
    walker = {16: native.index_scan16, 32: native.index_scan32}[width]
    got = walker(plist, VSYMS, _sets(path, width))
    assert got is not None, f"index_scan{width} refused the pool's sets"
    for p, scan in zip(plist, got):
        want = native.index_scan(p, VSYMS)
        assert len(scan) == len(want)
        for a, b in zip(scan, want):
            np.testing.assert_array_equal(a, b)


def _pack_both(plist_jax, monkeypatch):
    """The port's ``pack_virtual_segments`` in a fresh walk pool whose
    history raised the mmap threshold at the streams' own key, and the
    JAX package's on the same streams; returns (mine, ref, counts)."""
    mlist = [convert.params_from_jax(p) for p in plist_jax]
    caps = [native.index_job_capacities(p, VSYMS) for p in mlist]
    monkeypatch.setattr(staging, "_walk_pool", staging.IdxBufPool())
    _raise_mmap_threshold(staging.walk_buffer_pool(),
                          max(c[0] for c in caps), max(c[1] for c in caps))
    _, bank_of = tables.DeviceScanTables.from_params_banked(mlist)
    tb = tables.GroupGeometry.from_params(mlist[0], len(mlist)).total_blocks
    pack.reset_walk_counts()
    mine = pack.pack_virtual_segments(mlist, tb, VSYMS, bank_of=bank_of)
    counts = pack.walk_counts()
    ref = de.pack_virtual_segments(plist_jax, tb, VSYMS, bank_of=bank_of)
    return mine, ref, counts


def _assert_packs_equal(mine, ref):
    (packed, dc_m, lom_m), (ref_packed, dc_r, lom_r) = mine, ref
    n = int(np.count_nonzero(ref_packed.mcu_count))
    assert n > len(lom_r) and np.count_nonzero(packed.mcu_count) == n
    _assert_prefix_equal(packed, ref_packed, n)
    np.testing.assert_array_equal(dc_m[:n], dc_r[:n])
    np.testing.assert_array_equal(lom_m, lom_r)


def _jax_params(n, variants=None):
    return [JaxParser().parse(encoder.encode_planes(
        encoder.random_planes("420", 64, 48, seed=s), "420",
        restart_interval=0, table_variant=variants[s] if variants else 0))
        for s in range(n)]


@pytest.mark.parametrize("width", [16, 32])
def test_uniform_chunk_is_walked_by_the_wide_walker(width, monkeypatch):
    mine, ref, counts = _pack_both(_jax_params(width), monkeypatch)
    want = dict.fromkeys(pack.WALK_COUNTS, 0)
    want[f"index_scan{width}"] = 1
    assert counts == want
    _assert_packs_equal(mine, ref)


# Two table variants in one 16-stream chunk: index_scan16 hands it back,
# and so does index_scan8 where a half still mixes them.
MIXED = {
    "halves": ((0,) * 8 + (1,) * 8, {"narrowed": 1, "index_scan8": 2}),
    "alternating": ((0, 1) * 8, {"narrowed": 3, "index_scan2": 8}),
}


@pytest.mark.parametrize("layout", list(MIXED))
def test_mixed_tables_chunk_is_narrowed_and_matches_jax(layout, monkeypatch):
    variants, expect = MIXED[layout]
    mine, ref, counts = _pack_both(_jax_params(16, variants), monkeypatch)
    want = dict.fromkeys(pack.WALK_COUNTS, 0)
    want.update(expect)
    assert counts == want
    _assert_packs_equal(mine, ref)


def test_a_width_past_the_slabs_reach_is_halved_first(monkeypatch):
    """A chunk whose slab would pass the AVX-512 walkers' 32-bit offsets
    goes to a narrower walker before any walker is called, and is counted
    ``span_narrowed``; its records are those of the single-stream walk."""
    plist = _dri0_params(32)
    cb = native.index_job_capacities(plist[0], VSYMS)[0]
    # A limit that holds 16 streams of this capacity but not 32.
    monkeypatch.setattr(staging, "SLAB_SPAN_LIMIT",
                        16 * staging.slab_stride(cb))
    monkeypatch.setattr(staging, "_walk_pool", staging.IdxBufPool())
    pack.reset_walk_counts()
    scans, tokens = pack.index_walk(plist, VSYMS)
    want = dict.fromkeys(pack.WALK_COUNTS, 0)
    want.update(index_scan16=2, span_narrowed=2)
    assert pack.walk_counts() == want
    for p, scan in zip(plist, scans):
        for a, b in zip(scan, native.index_scan(p, VSYMS)):
            np.testing.assert_array_equal(a, b)
    for token in tokens:
        staging.walk_buffer_pool().release(token)


def test_counts_reset():
    pack.reset_walk_counts()
    pack.index_walk(_dri0_params(2), VSYMS)
    assert pack.walk_counts()["index_scan2"] == 1
    pack.reset_walk_counts()
    assert pack.walk_counts() == dict.fromkeys(pack.WALK_COUNTS, 0)


def test_counts_hold_under_concurrent_walks():
    """Walks from more threads than cores, with the interpreter switching
    threads every microsecond: no count is lost."""
    import concurrent.futures
    import sys
    plist = _dri0_params(2)
    n = 4 * 8
    pack.reset_walk_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(n) as pool:
            futs = [pool.submit(pack.index_walk, plist, VSYMS)
                    for _ in range(n)]
            for fut in futs:
                fut.result(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert pack.walk_counts()["index_scan2"] == n
