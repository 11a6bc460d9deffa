"""K0, the DRI=0 sync, on the CPU: its plain version and its CUDA source.

A DRI=0 group on a card takes the sync route: the host unstuffs the
streams into the staging buffer (``ops.pack.stage_clean_streams``) and K0
(``kernels/sync.py``, ``csrc/sync.cu``) finds the lanes on the device. On
CPU tensors K0 runs its plain version, so ``pipeline.pack_group_synced``
on the CPU builds the lanes the card would, and the plain K1, K2 and K3
decode them. Every image must come out byte-identical to the host-walk
route (``pipeline.pack_group`` on the CPU: the native index walk and
``pack_virtual_segments``), for every subsampling, two table banks, ROI
crops and subsequence lengths that put lane boundaries inside MCUs, at
stuffed bytes and in the fill bits. A corrupt stream flags its image's
lanes, which ``check_errors`` turns into BAD_JPEG.

``csrc/sync.cu`` itself is compiled for the host with g++ (a thread a CUDA
thread, one resident block, so the cooperative grid's rounds run as block
passes) and held against the plain version, output for output.
"""

import contextlib
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from rocjpeg_tpu_torch import api, pipeline
from rocjpeg_tpu_torch.core.bitstream import JpegStreamParser
from rocjpeg_tpu_torch.kernels import build, sync
from rocjpeg_tpu_torch.ops import pack, staging
from rocjpeg_tpu_torch.ops.tables import DeviceScanTables, GroupGeometry
from rocjpeg_tpu_torch.runtime import native
from rocjpeg_tpu_torch.status import RocJpegError, Status
from rocjpeg_tpu_torch.testing import encoder
from rocjpeg_tpu_torch.types import CropRectangle, DecodeParams, OutputFormat

F = OutputFormat


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain kernels step over small tensors: torch's intra-op pool only
    spins there, against the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blobs(css, w=72, h=66, n=2, noise=6.0, table_variants=(0, 0),
           optimize=False):
    out = []
    for s in range(n):
        rng = np.random.default_rng(100 + s)
        hf, vf = {"444": (1, 1), "440": (1, 2), "422": (2, 1),
                  "420": (2, 2), "400": (1, 1)}[css]

        def plane(ph, pw):
            base = rng.integers(0, 256, (ph // 8 + 1, pw // 8 + 1))
            up = np.kron(base, np.ones((8, 8)))[:ph, :pw]
            return np.clip(up + rng.normal(0, noise, (ph, pw)), 0,
                           255).astype(np.uint8)

        planes = [plane(h, w)]
        if css != "400":
            planes += [plane(h // vf, w // hf), plane(h // vf, w // hf)]
        out.append(encoder.encode_planes(
            planes, css, restart_interval=0,
            table_variant=table_variants[s % len(table_variants)],
            optimize=optimize))
    return out


def _params(blobs):
    return [JpegStreamParser().parse(b) for b in blobs]


def _decode(g, plist, fmt, crop):
    images, err = pipeline.decode_group_device_entropy(g, plist, fmt, crop)
    return images, err


def _assert_same(a, b):
    assert len(a) == len(b)
    for ia, ib in zip(a, b):
        for (ca, pa), (cb, pb) in zip(ia, ib):
            assert pa == pb
            assert torch.equal(ca, cb)


@contextlib.contextmanager
def _subseq_bits(bits):
    """Lanes of ``bits`` bits of stream (``ops.pack.SUBSEQ_BITS``)."""
    saved, pack.SUBSEQ_BITS = pack.SUBSEQ_BITS, bits
    try:
        yield
    finally:
        pack.SUBSEQ_BITS = saved


def _synced(plist, crop=None, subseq_bits=pack.SUBSEQ_BITS):
    with _subseq_bits(subseq_bits):
        return pipeline.pack_group_synced(plist, "cpu", crop)


def _both_routes(plist, crop=None, subseq_bits=pack.SUBSEQ_BITS,
                 fmt=F.RGB):
    walked = pipeline.pack_group(plist, "cpu", crop,
                                 virtual_k=api.VIRTUAL_SYMBOLS)
    synced = _synced(plist, crop, subseq_bits)
    a, ea = _decode(walked, plist, fmt, crop)
    b, eb = _decode(synced, plist, fmt, crop)
    assert not ea.any() and not eb.any()
    _assert_same(a, b)
    return synced


CROPS = {"full": None, "roi": CropRectangle(8, 18, 60, 50)}


@pytest.mark.parametrize("crop", sorted(CROPS))
@pytest.mark.parametrize("subseq_bits", [pack.SUBSEQ_BITS, 48])
@pytest.mark.parametrize("css", ["444", "440", "422", "420", "400"])
def test_sync_route_matches_host_walk(css, subseq_bits, crop):
    """Every subsampling, a whole stream in one subsequence and lanes cut
    every 48 bits (inside MCUs), whole frames and an ROI."""
    g = _both_routes(_params(_blobs(css)), CROPS[crop], subseq_bits)
    assert g.lane_img.shape == (g.packed.word_off.shape[0],)


@pytest.mark.parametrize("fmt", [F.NATIVE, F.Y])
def test_two_table_banks(fmt):
    plist = _params(_blobs("420", n=3, table_variants=(0, 1)))
    _, bank_of = DeviceScanTables.from_params_banked(plist)
    assert len(set(bank_of.tolist())) == 2
    g = _both_routes(plist, subseq_bits=64, fmt=fmt)
    lanes = g.packed.lane_bank.numpy()[:len(g.lane_img)]
    assert set(lanes[g.packed.mcu_count.numpy() > 0]) == {0, 1}


@pytest.mark.parametrize("case", ["shorter than a subsequence",
                                  "MCUs longer than a subsequence"])
def test_subsequence_edges(case):
    if case == "shorter than a subsequence":
        plist = _params(_blobs("420", w=16, h=16, n=2))
        g = _both_routes(plist)
        counts = g.packed.mcu_count.numpy()
        assert (counts[:2] > 0).all() and not counts[2:].any()
    else:
        plist = _params(_blobs("444", w=48, h=40, n=1, noise=60.0))
        g = _both_routes(plist, subseq_bits=32)
        counts = g.packed.mcu_count.numpy()[:len(np.nonzero(
            g.lane_img == 0)[0])]
        assert (counts == 0).any() and (counts > 0).any()


def _clean(p):
    return bytes(native.unstuff(p.slice_data))


def test_boundaries_at_stuffed_bytes_and_fill_bits():
    """Subsequence boundaries at the first bit of a stuffed 0xFF byte (its
    0x00 gone from the clean stream), inside one, and in the last bits of
    the stream, where the encoder's fill bits are. Optimised tables make
    streams with 0xFF bytes."""
    plist = _params(_blobs("420", w=64, h=64, n=1, noise=30.0,
                           optimize=True))
    assert b"\xff\x00" in plist[0].slice_data
    clean = _clean(plist[0])
    ff = next(i for i, c in enumerate(clean) if c == 0xFF and i >= 8)
    nbits = 8 * len(clean)
    for bits in (8 * ff, 8 * ff + 5, (nbits - 2) // 4, (nbits - 6) // 4):
        _both_routes(plist, subseq_bits=bits, fmt=F.Y)


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("css", ["444", "440", "422", "420", "400"])
def test_slot_period(css, optimize):
    """The period of the slots' tables, which K0 seeks its fixed point on:
    the test encoder writes one table set for every component (period 1),
    its optimised tables one a component (the MCU's blocks); a
    one-component scan has one block an MCU."""
    plist = _params(_blobs(css, n=2, optimize=optimize))
    nslots = {"444": 3, "440": 4, "422": 4, "420": 6, "400": 1}[css]
    assert pack.slot_period(plist) == (nslots if optimize else 1)
    g = _synced(plist)
    assert not g.lane_err.any()


def _truncated(blob):
    p = JpegStreamParser().parse(blob)
    p.slice_data = p.slice_data[:len(p.slice_data) // 3]
    return p


def _invalid_code(blob):
    """All-ones runs make no code of these tables: a code of 16 ones is
    never assigned."""
    p = JpegStreamParser().parse(blob)
    bad = bytearray(p.slice_data)
    mid = len(bad) // 2
    bad[mid:mid + 12] = b"\xff\x00" * 6
    p.slice_data = bytes(bad)
    return p


CORRUPT = {"truncated": _truncated, "invalid code": _invalid_code}


@pytest.mark.parametrize("kind", sorted(CORRUPT))
def test_corrupt_stream_flags_its_lanes(kind):
    blobs = _blobs("420", w=64, h=48, n=3)
    plist = _params(blobs)
    plist[1] = CORRUPT[kind](blobs[1])
    g = _synced(plist, subseq_bits=256)
    err = g.lane_err.numpy()
    img = g.lane_img
    assert err[img == 1].all() and not err[img != 1].any()
    assert g.rejected.tolist() == [1]
    assert not g.packed.mcu_count.numpy()[img == 1].any()
    _, flags = _decode(g, plist, F.Y, None)
    assert sorted(set(img[np.nonzero(flags.numpy())[0]])) == [1]


@pytest.fixture
def synced_decoder(monkeypatch):
    """A CPU ``Decoder`` whose DRI=0 groups take the card's route (K0's
    plain version) instead of the host walk."""
    def pack_group(plist, device, crop=None, virtual_k=None):
        if virtual_k:
            return pipeline.pack_group_synced(plist, device, crop)
        return original(plist, device, crop, virtual_k)

    original = pipeline.pack_group
    monkeypatch.setattr(pipeline, "pack_group", pack_group)
    return lambda check: api.Decoder(device="cpu", device_entropy="on",
                                     check_errors=check)


@pytest.mark.parametrize("kind", sorted(CORRUPT))
def test_corrupt_stream_raises_bad_jpeg(synced_decoder, kind):
    blobs = _blobs("420", w=64, h=64, n=3)
    streams = [api.JpegStream(b) for b in blobs]
    bad = CORRUPT[kind](blobs[2])
    streams[2].params.slice_data = bad.slice_data
    dec = synced_decoder(True)
    with pytest.raises(RocJpegError) as ei:
        dec.decode_batched(streams, DecodeParams(F.Y))
    assert (ei.value.status.name, int(ei.value.status)) == ("BAD_JPEG", -3)
    assert dec.last_failed_indices() == [2]
    assert [p for p, _ in dec.last_paths] == ["wave-virtual"]
    # Without the error check too, as the host-walk route raises (its walk
    # refuses the stream and the host path raises).
    for dec in (synced_decoder(False),
                api.Decoder(device="cpu", device_entropy="on",
                            check_errors=False)):
        with pytest.raises(RocJpegError) as ei:
            dec.decode_batched(streams, DecodeParams(F.Y))
        assert (ei.value.status.name, int(ei.value.status)) == (
            "BAD_JPEG", -3)


def _embedded_marker(p):
    p.slice_data = p.slice_data[:20] + b"\xff\xd3" + p.slice_data[22:]


def _dc_size_past_11(p):
    t = p.huffman_tables[p.scan_components[0].dc_table_selector]
    t.dc_values = np.array(t.dc_values, np.uint8)
    t.dc_values[0] = 12


REFUSED = {"embedded restart marker": _embedded_marker,
           "DC size past 11": _dc_size_past_11}


def _outcome(dec, streams):
    try:
        images = dec.decode_batched(streams, DecodeParams(F.Y))
    except RocJpegError as exc:
        return ("error", exc.status.name, [p for p, _ in dec.last_paths])
    return ("decoded", dec.last_failed_indices(),
            [p for p, _ in dec.last_paths],
            [np.asarray(img.channel[0]).tobytes() for img in images])


@pytest.mark.parametrize("kind", sorted(REFUSED))
def test_refusals_take_the_host_path(synced_decoder, kind):
    """A stream that does not unstuff, or whose tables the host walk
    refuses, raises BAD_JPEG in the host half, and the chunk takes the host
    path: the same outcome as the host-walk route's."""
    blobs = _blobs("420", w=64, h=64, n=2)
    plist = _params(blobs)
    REFUSED[kind](plist[0])
    with pytest.raises(RocJpegError) as ei:
        pipeline.pack_group_synced(plist, "cpu")
    assert ei.value.status == Status.BAD_JPEG
    assert pack._walk_refuses(plist[0]) == (kind == "DC size past 11")
    assert not pack._walk_refuses(plist[1])
    outcomes = []
    for dec in (synced_decoder(False),
                api.Decoder(device="cpu", device_entropy="on",
                            check_errors=False)):
        streams = [api.JpegStream(b) for b in blobs]
        REFUSED[kind](streams[0].params)
        outcomes.append(_outcome(dec, streams))
    assert outcomes[0] == outcomes[1]


def test_lane_arrays_match_a_sequential_walk():
    """The plain version's table on a hand-checked case: lane t starts at
    the first MCU boundary at or after t * S."""
    plist = _params(_blobs("400", w=32, h=8, n=1, noise=30.0))
    g = _synced(plist, subseq_bits=64)
    clean = _clean(plist[0])
    T = -(-8 * len(clean) // 64)
    starts = g.packed.mcu_start.numpy()[:T]
    counts = g.packed.mcu_count.numpy()[:T]
    assert starts[0] == 0 and (np.diff(starts) >= 0).all()
    assert counts.sum() == 4 and (counts[:-1] == np.diff(starts)).all()
    lom = g.packed.lane_of_mcu.numpy()[0]
    for m in range(4):
        lane = lom[m]
        assert starts[lane] <= m < starts[lane] + counts[lane]
    word_off = g.packed.word_off.numpy()
    assert (np.diff(word_off[:T]) >= 0).all()


# --- csrc/sync.cu compiled for the host ------------------------------------

_SHIM = r"""
#pragma once
#include <algorithm>
#include <climits>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx(0, 0, 0), blockIdx(0, 0, 0);
inline dim3 gridDim, blockDim;
struct EmuBarrier {
  std::mutex m;
  std::condition_variable cv;
  int n = 0, count = 0, gen = 0;
  void wait() {
    std::unique_lock<std::mutex> lk(m);
    const int g = gen;
    if (++count == n) {
      count = 0;
      ++gen;
      cv.notify_all();
    } else {
      cv.wait(lk, [&] { return gen != g; });
    }
  }
};
inline EmuBarrier g_block_bar;
inline EmuBarrier g_warp_bar[64];
inline int g_or[2];
inline thread_local int t_or_calls = 0;
inline unsigned g_shfl[64][32];
inline void __syncthreads() { g_block_bar.wait(); }
inline int __syncthreads_or(int p) {
  const int slot = t_or_calls++ & 1;
  if (p) __atomic_fetch_or(&g_or[slot], 1, __ATOMIC_SEQ_CST);
  __syncthreads();
  const int r = __atomic_load_n(&g_or[slot], __ATOMIC_SEQ_CST);
  __syncthreads();
  if (threadIdx.x == 0) __atomic_store_n(&g_or[slot], 0, __ATOMIC_SEQ_CST);
  return r;
}
inline unsigned __shfl_up_sync(unsigned, unsigned v, int d) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  g_shfl[w][l] = v;
  g_warp_bar[w].wait();
  const unsigned r = l >= d ? g_shfl[w][l - d] : v;
  g_warp_bar[w].wait();
  return r;
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicMax(int* p, int v) {
  int cur = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (cur < v && !__atomic_compare_exchange_n(
                        p, &cur, v, false, __ATOMIC_SEQ_CST,
                        __ATOMIC_SEQ_CST)) {
  }
  return cur;
}
template <typename T> inline T __ldg(const T* p) { return *p; }
template <typename T> inline T __ldcg(const T* p) {
  return __atomic_load_n(p, __ATOMIC_SEQ_CST);
}
template <typename T> inline void __stcg(T* p, T v) {
  __atomic_store_n(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned __byte_perm(unsigned a, unsigned b, unsigned s) {
  const unsigned long long v = (static_cast<unsigned long long>(b) << 32) | a;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i)
    r |= static_cast<unsigned>((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF)
         << (8 * i);
  return r;
}
using std::max;
using std::min;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidConfiguration = 9 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 1;
  return 0;
}
template <typename F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, F, int, size_t) {
  *n = 1;
  return 0;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
// Blocks one after another, the threads of a block side by side.
template <typename A>
inline void emu_launch(void (*f)(A), int grid, int threads, A a) {
  gridDim = dim3(grid);
  blockDim = dim3(threads);
  g_block_bar.n = threads;
  for (int w = 0; w < threads / 32; ++w) g_warp_bar[w].n = 32;
  for (int b = 0; b < grid; ++b) {
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([=] {
        threadIdx = dim3(t);
        blockIdx = dim3(b);
        t_or_calls = 0;
        f(a);
      });
    for (auto& t : ts) t.join();
  }
}
// One resident block: the grid's rounds become the block's.
template <typename A>
inline cudaError_t cudaLaunchCooperativeKernel(void (*f)(A), dim3, dim3 b,
                                               void** args, size_t,
                                               cudaStream_t) {
  emu_launch(f, 1, static_cast<int>(b.x), *static_cast<A*>(args[0]));
  return 0;
}
"""
_CG = r"""
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct grid_group {
  void sync() { __syncthreads(); }
};
inline grid_group this_grid() { return grid_group(); }
}
"""
_LAUNCH = re.compile(r"(\w+)<<<([^,]+), (\w+), (\w+), st>>>\(a\);")
# The package's build, and first entries from the plain guess alone (more
# passes and rounds before the fixed point).
SYNC_VARIANTS = {"default": (), "no warm-up": ("RJT_SYNC_WARM=0",)}


@pytest.fixture(scope="module")
def host_sync(tmp_path_factory):
    """``csrc/sync.cu`` compiled for the host (see the module docstring)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to compile the kernel source for the host")
    tmp = tmp_path_factory.mktemp("sync_host")
    with open(f"{build.CSRC}/sync.cu") as f:
        src = f.read()
    assert len(_LAUNCH.findall(src)) == 4
    src = _LAUNCH.sub(r"emu_launch(\1, \2, \3, a);", src)
    src = src.replace("reinterpret_cast<void*>(sync_kernel)", "sync_kernel")
    src = src.replace("extern __shared__ uint32_t s_mem[];",
                      "static uint32_t s_mem[16384];")
    (tmp / "cuda_runtime.h").write_text(_SHIM)
    (tmp / "cooperative_groups.h").write_text(_CG)
    (tmp / "sync_host.cpp").write_text(src)
    procs = {name: subprocess.Popen(
        ["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread",
         f"-I{tmp}", *(f"-D{d}" for d in defines), "-o",
         str(tmp / f"libsync_host_{i}.so"), str(tmp / "sync_host.cpp")],
        stderr=subprocess.PIPE) for i, (name, defines)
        in enumerate(SYNC_VARIANTS.items())}
    libs = {}
    for i, (name, proc) in enumerate(procs.items()):
        _, err = proc.communicate()
        assert proc.returncode == 0, err.decode()
        lib = ctypes.CDLL(str(tmp / f"libsync_host_{i}.so"))
        for entry in ("rjt_sync_scratch_bytes", "rjt_sync_lanes"):
            fn = getattr(lib, entry)
            fn.argtypes = build.SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _host_kernel_lanes(lib, plist, subseq_bits, crop, period=None):
    """The host-compiled kernels' lanes of a group, and the plain
    version's, from one staging of the streams; ``period`` the slots'
    table period given to the kernels (None: the group's)."""
    geom = GroupGeometry.from_params(plist[0], len(plist))
    tables, bank_of = DeviceScanTables.from_params_banked(plist)
    st = staging.Stager()
    with _subseq_bits(subseq_bits):
        plan = pack.stage_clean_streams(plist, len(geom.flat_off), bank_of,
                                        st)
    clean = torch.from_numpy(st.view("clean").view(np.int32).copy())
    img = torch.from_numpy(plan.img.copy())
    lentab = torch.from_numpy(tables.lentab.view(np.int32).copy())
    values = torch.from_numpy(tables.values.view(np.int32).copy())
    total = pack._total_mcus(plist[0])
    mcu_range = pipeline._roi_mcu_range(plist[0], crop)
    want = sync.sync_lanes(clean, img, lentab, values, geom, total,
                           plan.n_sub, plan.n_pad, plan.n_dense,
                           subseq_bits, mcu_range)
    B, n_pad = len(plist), plan.n_pad
    got = sync.SyncedLanes(
        dense=torch.full((plan.n_dense,), 0x5A5A5A5A, dtype=torch.int32),
        **{k: torch.full((n_pad,), -7, dtype=torch.int32) for k in (
            "word_off", "img_base", "mcu_start", "mcu_count", "lane_bank")},
        dc_flat=torch.full((n_pad, 3), -7, dtype=torch.int32),
        lane_of_mcu=torch.full((B, total), -7, dtype=torch.int32),
        lane_err=torch.ones(n_pad, dtype=torch.bool),
        rejected=torch.full((1,), -7, dtype=torch.int32))
    scratch = np.full(lib.rjt_sync_scratch_bytes(plan.n_sub, B), 0xA5,
                      np.uint8)
    rounds = np.zeros(2, np.int32)
    geom_tab = np.ascontiguousarray(
        [geom.dc_slot, geom.ac_slot, geom.comp_of_slot], dtype=np.int32)
    lo, hi = mcu_range if mcu_range is not None else (0, total)
    rc = lib.rjt_sync_lanes(
        clean.data_ptr(), clean.numel(), img.data_ptr(), B, plan.n_sub,
        n_pad, lentab.data_ptr(), values.data_ptr(), tables.n_banks,
        geom_tab.ctypes.data, len(geom.flat_off),
        plan.period if period is None else period, subseq_bits, total,
        geom.total_blocks, lo, hi, scratch.ctypes.data,
        got.word_off.data_ptr(), got.img_base.data_ptr(),
        got.mcu_start.data_ptr(), got.mcu_count.data_ptr(),
        got.lane_bank.data_ptr(), got.dc_flat.data_ptr(),
        got.lane_err.data_ptr(), got.rejected.data_ptr(),
        got.lane_of_mcu.data_ptr(),
        got.dense.data_ptr(), plan.n_dense, rounds.ctypes.data, None)
    assert rc == 0
    return got, want, rounds


HOST_CASES = {
    "420 S=4096": ("420", 4096, None, None),
    "420 S=32 roi": ("420", 32, CropRectangle(8, 18, 60, 50), None),
    "444 S=40": ("444", 40, None, None),
    "422 S=33": ("422", 33, None, None),
    "400 S=32": ("400", 32, None, None),
    "420 S=64 truncated": ("420", 64, None, "truncated"),
    "420 S=64 invalid code": ("420", 64, None, "invalid code"),
}
# The slots' tables: one set for every component (K0 syncs on the slot
# modulo period 1, then counts blocks), one a component (on the slot), and
# one set given the MCU's period (the plain fixed point on the slot).
TABLES = {"shared": (False, None), "per component": (True, None),
          "shared, MCU period": (False, "mcu")}


@pytest.mark.parametrize("tables", sorted(TABLES))
@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_kernel_source_matches_plain_version(host_sync, case, tables):
    css, bits, crop, corrupt = HOST_CASES[case]
    optimize, period = TABLES[tables]
    blobs = _blobs(css, n=2, table_variants=(0, 1), optimize=optimize)
    plist = _params(blobs)
    if corrupt:
        plist[1] = CORRUPT[corrupt](blobs[1])
    nslots = len(GroupGeometry.from_params(plist[0], 1).flat_off)
    assert pack.slot_period(plist) == (nslots if optimize or css == "400"
                                       else 1)
    for variant, lib in host_sync.items():
        got, want, rounds = _host_kernel_lanes(
            lib, plist, bits, crop, None if period is None else nslots)
        for name in ("word_off", "img_base", "mcu_start", "mcu_count",
                     "lane_bank", "dc_flat", "lane_of_mcu", "lane_err",
                     "rejected", "dense"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          getattr(want, name).numpy(),
                                          f"{variant}: {name}")
        assert rounds[0] >= 2 and rounds[1] >= 1
        assert bool(want.lane_err.any()) == bool(corrupt)
