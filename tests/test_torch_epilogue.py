"""K3, the output epilogue: the port's wrapper against the JAX package.

``rocjpeg_tpu_torch.kernels.epilogue.render`` on CPU tensors (where it runs
the kernel's plain PyTorch version) and
``rocjpeg_tpu.ops.postprocess.render_output(np, ...)`` render the same
seeded uint8 planes; every channel must be byte-equal (tolerance 0) with the
same pitch, for every subsampling, format and ROI phase, into tensors the
wrapper allocates and into pitched caller destinations. The cases neither
version can render, and the wrapper's refusals, are pinned with their
Status. The CUDA source has no CPU mode; its arithmetic and addressing are
held against the plain version here by compiling ``csrc/epilogue.cu`` for
the host with one thread a block, and on the card by ``chip_smoke.py``.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from rocjpeg_tpu.ops import color as jcolor
from rocjpeg_tpu.ops import postprocess as jpost
from rocjpeg_tpu.types import CropRectangle as JCrop
from rocjpeg_tpu_torch.kernels import build, epilogue
from rocjpeg_tpu_torch.ops import color as tcolor
from rocjpeg_tpu_torch.status import RocJpegError, Status
from rocjpeg_tpu_torch.types import (ChromaSubsampling, CropRectangle,
                                     DecodedImage, OutputFormat)

CSS = ChromaSubsampling
F = OutputFormat
FACTORS = {CSS.CSS_444: (1, 1), CSS.CSS_440: (1, 2), CSS.CSS_422: (2, 1),
           CSS.CSS_420: (2, 2), CSS.CSS_400: (1, 1)}
CROPS = {"full": None, "even": CropRectangle(8, 4, 40, 30),
         "odd": CropRectangle(3, 5, 36, 28),       # 33 x 23 at (3, 5)
         "odd-even-w": CropRectangle(3, 5, 37, 28)}  # 34 x 23 at (3, 5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The renders here are small: torch's intra-op pool only spins, against
    the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planes(css, w, h, batch=2, seed=0):
    """MCU-padded random planes as numpy arrays (y, u, v)."""
    rng = np.random.default_rng(seed)
    hf, vf = FACTORS[css]
    pw, ph = -(-w // (8 * hf)) * 8 * hf, -(-h // (8 * vf)) * 8 * vf
    y = rng.integers(0, 256, (batch, ph, pw), dtype=np.uint8)
    if css == CSS.CSS_400:
        return (y, None, None)
    return (y, rng.integers(0, 256, (batch, ph // vf, pw // hf), np.uint8),
            rng.integers(0, 256, (batch, ph // vf, pw // hf), np.uint8))


def _torch(planes):
    return tuple(None if p is None else torch.from_numpy(p) for p in planes)


def _jax_render(css, planes, w, h, fmt, crop):
    jcrop = None if crop is None else JCrop(crop.left, crop.top, crop.right,
                                            crop.bottom)
    return jpost.render_output(np, int(css), planes, w, h, int(fmt), jcrop)


def _assert_same(got, want):
    assert len(got) == len(want)
    for (a, pa), (b, pb) in zip(got, want):
        assert pa == pb
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), b)


def _yuyv_refused(css, fmt, w, crop):
    eff_w = w if crop is None else crop.width
    return css == CSS.CSS_422 and fmt == F.NATIVE and eff_w % 2 == 1


MATRIX = ([(css, fmt, name, 64, 48) for css in FACTORS for fmt in F
           for name in ("full", "even", "odd")]
          + [(css, fmt, name, 131, 97) for css in FACTORS for fmt in F
             for name in ("full", "odd")])


@pytest.mark.parametrize(
    "css,fmt,crop,w,h", MATRIX,
    ids=[f"{c.name[4:]}-{f.name}-{n}-{w}x{h}" for c, f, n, w, h in MATRIX])
def test_render_matches_jax(css, fmt, crop, w, h):
    crop = CROPS[crop]
    planes = _planes(css, w, h, seed=w + int(css))
    if _yuyv_refused(css, fmt, w, crop):
        # Packed YUYV of an odd width: the JAX package fails in its
        # reshape; the port refuses with a typed error.
        with pytest.raises(ValueError):
            _jax_render(css, planes, w, h, fmt, crop)
        with pytest.raises(RocJpegError) as ei:
            epilogue.render(css, _torch(planes), w, h, fmt, crop)
        assert ei.value.status == Status.INVALID_PARAMETER
        return
    want = _jax_render(css, planes, w, h, fmt, crop)
    _assert_same(epilogue.render(css, _torch(planes), w, h, fmt, crop), want)
    # The wrapper's own account of the channels (what the kernel route
    # allocates and checks destinations against) agrees with them.
    eff_w, eff_h = (w, h) if crop is None else (crop.width, crop.height)
    _mode, plan = epilogue.channel_plan(css, fmt, eff_w, eff_h)
    assert ([(ch.rows, ch.row_bytes, ch.pitch) for ch in plan]
            == [(a.shape[1], a.shape[2], p) for a, p in want])


def _alloc_dests(want, slack, batch, spare=3):
    dests = []
    for i in range(batch):
        d = DecodedImage.empty()
        for ci, (arr, _pitch) in enumerate(want):
            pitch = arr.shape[2] + slack
            d.channel[ci] = torch.full((arr.shape[1] * pitch + spare,), 0xA5,
                                       dtype=torch.uint8)
            d.pitch[ci] = pitch
        dests.append(d)
    return dests


def _check_dests(dests, want):
    for i, d in enumerate(dests):
        for ci, (arr, _pitch) in enumerate(want):
            if d.channel[ci] is None:
                continue
            rows, row, pitch = arr.shape[1], arr.shape[2], d.pitch[ci]
            buf = d.channel[ci].numpy()
            win = buf[:rows * pitch].reshape(rows, pitch)
            np.testing.assert_array_equal(win[:, :row], arr[i])
            assert (win[:, row:] == 0xA5).all(), "slack clobbered"
            assert (buf[rows * pitch:] == 0xA5).all()


DEST_CASES = [(css, fmt, slack) for css in FACTORS for fmt in F
              for slack in (0, 13)]


@pytest.mark.parametrize(
    "css,fmt,slack", DEST_CASES,
    ids=[f"{c.name[4:]}-{f.name}-slack{s}" for c, f, s in DEST_CASES])
def test_render_into_destinations_matches_jax(css, fmt, slack):
    crop = CROPS["odd-even-w" if (css, fmt) == (CSS.CSS_422, F.NATIVE)
                 else "odd"]
    planes = _planes(css, 64, 48, batch=3, seed=5)
    want = _jax_render(css, planes, 64, 48, fmt, crop)
    dests = _alloc_dests(want, slack, 3)
    if len(want) > 1:
        dests[1].channel[len(want) - 1] = None  # a channel left out
    assert epilogue.render(css, _torch(planes), 64, 48, fmt, crop,
                           dests) is None
    _check_dests(dests, want)


@pytest.mark.parametrize("css", [CSS.CSS_411, CSS.CSS_UNKNOWN])
def test_unsupported_subsampling_same_status(css):
    planes = _planes(CSS.CSS_420, 64, 48)
    from rocjpeg_tpu.status import RocJpegError as JErr
    with pytest.raises(JErr) as ej:
        _jax_render(css, planes, 64, 48, F.RGB, None)
    with pytest.raises(RocJpegError) as et:
        epilogue.render(css, _torch(planes), 64, 48, F.RGB, None)
    assert ((ej.value.status.name, int(ej.value.status))
            == (et.value.status.name, int(et.value.status))
            == ("JPEG_NOT_SUPPORTED", -4))


THIN = [(fmt, crop) for fmt in (F.RGB, F.RGB_PLANAR, F.NATIVE, F.YUV_PLANAR)
        for crop in (CropRectangle(3, 3, 4, 9), CropRectangle(3, 3, 9, 4),
                     CropRectangle(3, 3, 4, 4))]


@pytest.mark.parametrize(
    "fmt,crop", THIN,
    ids=[f"{f.name}-{c.width}x{c.height}" for f, c in THIN])
def test_roi_thinner_than_a_chroma_sample_matches_jax(fmt, crop):
    """A 4:2:0 ROI one pixel wide or high leaves an empty chroma plane: the
    JAX package then returns empty RGB / chroma channels, and so does the
    port (nothing is computed, nothing invented)."""
    planes = _planes(CSS.CSS_420, 64, 48)
    want = _jax_render(CSS.CSS_420, planes, 64, 48, fmt, crop)
    assert any(a.size == 0 for a, _ in want)
    _assert_same(epilogue.render(CSS.CSS_420, _torch(planes), 64, 48, fmt,
                                 crop), want)
    _mode, plan = epilogue.channel_plan(CSS.CSS_420, fmt, crop.width,
                                        crop.height)
    assert ([(ch.rows, ch.row_bytes, ch.pitch) for ch in plan]
            == [(a.shape[1], a.shape[2], p) for a, p in want])


@pytest.mark.parametrize("crop", [CropRectangle(40, 3, 72, 9),
                                  CropRectangle(3, 40, 9, 56),
                                  CropRectangle(-4, 3, 8, 9)],
                         ids=["right", "bottom", "negative"])
@pytest.mark.parametrize("fmt", [F.Y, F.RGB])
def test_roi_outside_the_planes_is_refused(fmt, crop):
    """A crop of valid size that leaves the decoded planes: the JAX package
    returns a clipped channel under the unclipped pitch, or fails to
    broadcast; the port refuses it on every device."""
    planes = _planes(CSS.CSS_420, 64, 48)
    try:
        out = _jax_render(CSS.CSS_420, planes, 64, 48, fmt, crop)
    except ValueError:
        pass
    else:
        assert out[0][0].shape[1:] != (crop.height,
                                       crop.width * (3 if fmt == F.RGB
                                                     else 1))
    with pytest.raises(RocJpegError) as ei:
        epilogue.render(CSS.CSS_420, _torch(planes), 64, 48, fmt, crop)
    assert ei.value.status == Status.INVALID_PARAMETER


def _bad_planes(kind):
    y, u, v = _torch(_planes(CSS.CSS_420, 64, 48))
    if kind == "dtype":
        return (y.to(torch.int16), u, v)
    if kind == "device":
        return (y, u.to("meta"), v)
    if kind == "non-contiguous":
        return (y, u, v.transpose(1, 2))
    if kind == "missing-chroma":
        return (y, None, None)
    if kind == "chroma-shape":
        return (y, u, v[:, :-8].contiguous())
    if kind == "batch":
        return (y, u[:1], v[:1])
    if kind == "rank":
        return (y[0], u, v)
    return (y, u)  # "arity"


@pytest.mark.parametrize("kind", ["dtype", "device", "non-contiguous",
                                  "missing-chroma", "chroma-shape", "batch",
                                  "rank", "arity"])
def test_wrapper_refuses_bad_planes(kind):
    with pytest.raises(RocJpegError) as ei:
        epilogue.render(CSS.CSS_420, _bad_planes(kind), 64, 48, F.RGB)
    assert ei.value.status == Status.INVALID_PARAMETER


def _bad_dests(kind):
    """Two destinations for an RGB_PLANAR render of 64 x 48, one spoilt."""
    dests = []
    for _ in range(2):
        d = DecodedImage.empty()
        for ci in range(3):
            d.channel[ci] = torch.zeros(48 * 64, dtype=torch.uint8)
            d.pitch[ci] = 64
        dests.append(d)
    d = dests[1]
    if kind == "null-channel-0":
        d.channel[0] = None
    elif kind == "short-pitch":
        d.pitch[2] = 63
    elif kind == "short-buffer":
        d.channel[1] = d.channel[1][:-1]
    elif kind == "dtype":
        d.channel[1] = torch.zeros(48 * 64, dtype=torch.int8)
    elif kind == "device":
        d.channel[1] = torch.zeros(48 * 64, dtype=torch.uint8, device="meta")
    elif kind == "non-contiguous":
        d.channel[1] = torch.zeros(48, 128, dtype=torch.uint8)[:, :64]
    elif kind == "numpy":
        d.channel[1] = np.zeros(48 * 64, np.uint8)
    elif kind == "count":
        dests = dests[:1]
    return dests


@pytest.mark.parametrize("kind", ["null-channel-0", "short-pitch",
                                  "short-buffer", "dtype", "device",
                                  "non-contiguous", "numpy", "count"])
def test_wrapper_refuses_bad_destinations(kind):
    planes = _torch(_planes(CSS.CSS_420, 64, 48))
    dests = _bad_dests(kind)
    with pytest.raises(RocJpegError) as ei:
        epilogue.render(CSS.CSS_420, planes, 64, 48, F.RGB_PLANAR, None,
                        dests)
    assert ei.value.status == Status.INVALID_PARAMETER
    # Refused before anything was written.
    assert not any(bool(c.any()) for d in dests for c in d.channel
                   if isinstance(c, torch.Tensor) and c.device.type == "cpu")


def test_cpu_render_launches_no_kernel(monkeypatch):
    monkeypatch.setattr(epilogue, "launches", 0)
    epilogue.render(CSS.CSS_420, _torch(_planes(CSS.CSS_420, 64, 48)), 64,
                    48, F.RGB)
    assert epilogue.launches == 0


# --- the CUDA source itself -------------------------------------------------

def _source(name="epilogue.cu"):
    with open(os.path.join(build.CSRC, name)) as f:
        return f.read()


@pytest.mark.parametrize("name", ["CR_V", "CG_U", "CG_V", "CB_U", "FIX_BITS"])
def test_kernel_constants_are_the_jax_packages(name):
    """The comments beside the JAX package's constants give two values the
    expressions do not evaluate to; the kernel must carry the evaluated
    ones."""
    cname = "k" + "".join(p.capitalize() for p in name.split("_"))
    m = re.search(rf"constexpr int {cname} = (-?\d+);", _source())
    assert m, cname
    assert int(m.group(1)) == getattr(jcolor, name) == getattr(tcolor, name)


_CTYPE = {"int": ctypes.c_int, "int64_t": ctypes.c_int64}


@pytest.mark.parametrize("entry", sorted(build.SIGNATURES))
def test_ctypes_signature_matches_the_c_entry_point(entry):
    """No compiler checks the bindings here: each C entry point's
    parameter list is read from the source and held against the argtypes
    the loader declares."""
    text = "".join(_source(n) for n in sorted(os.listdir(build.CSRC))
                   if n.endswith(".cu"))
    m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text)
    assert m, entry
    args = [a.strip() for a in m.group(1).split(",") if a.strip()]
    want = [ctypes.c_void_p if "*" in a
            else _CTYPE[a.replace("const ", "").split()[0]] for a in args]
    assert want == build.SIGNATURES[entry]


_SHIM = r"""
#pragma once
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline void rjt_aligned(const void* p, unsigned n) {
  if (reinterpret_cast<uintptr_t>(p) & (n - 1)) {
    std::fprintf(stderr, "misaligned %u-byte access\n", n);
    std::abort();
  }
}
// A vector access must be aligned on both sides: every copy checks its
// source, every assignment its target too. Scalar accesses are checked by
// the compiler (-fsanitize=alignment traps).
struct alignas(16) uint4 {
  unsigned x, y, z, w;
  uint4() = default;
  uint4(const uint4& o) {
    rjt_aligned(&o, 16);
    x = o.x; y = o.y; z = o.z; w = o.w;
  }
  uint4& operator=(const uint4& o) {
    rjt_aligned(this, 16); rjt_aligned(&o, 16);
    x = o.x; y = o.y; z = o.z; w = o.w;
    return *this;
  }
};
struct alignas(8) uint2 {
  unsigned x, y;
  uint2() = default;
  uint2(const uint2& o) { rjt_aligned(&o, 8); x = o.x; y = o.y; }
  uint2& operator=(const uint2& o) {
    rjt_aligned(this, 8); rjt_aligned(&o, 8);
    x = o.x; y = o.y;
    return *this;
  }
};
template <typename T> inline T __ldg(const T* p) { return *p; }
inline unsigned __byte_perm(unsigned a, unsigned b, unsigned s) {
  const unsigned long long v = (static_cast<unsigned long long>(b) << 32) | a;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i)
    r |= static_cast<unsigned>((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF)
         << (8 * i);
  return r;
}
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned shift) {
  const unsigned long long v = (static_cast<unsigned long long>(hi) << 32) | lo;
  return static_cast<unsigned>(v >> (shift & 31));
}
static dim3 threadIdx(0, 0, 0), blockIdx(0, 0, 0);
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
using std::max;
using std::min;
inline void __syncthreads() {}
"""
_LAUNCH = re.compile(r"(\w+_kernel<MODE(?:, ROWS)?>)"
                     r"<<<grid, kThreads, 0, stream>>>\(g, dt\);")
_LOOP = (r"for (unsigned z = 0; z < grid.z; ++z) "
         r"for (unsigned r = 0; r < grid.y; ++r) "
         r"for (unsigned x = 0; x < grid.x; ++x) "
         r"{ blockIdx = dim3(x, r, z); \1(g, dt); }")
# Builds of the source the host harness holds against the plain version:
# the package's, the first version that kernels/k3_steps.py times it
# against, and its other measurement variants.
VARIANTS = {
    "default": (),
    "baseline": ("RJT_EPI_BASELINE=1",),
    "one-row-units": ("RJT_EPI_PAIR=0",),
    "steps-off": ("RJT_EPI_WORDS=0", "RJT_EPI_PAIR=0", "RJT_EPI_BUFFERS=1",
                  "RJT_EPI_STRIP=1"),
}


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """``csrc/epilogue.cu`` compiled for the host, once per variant."""
    return compile_host_kernels(tmp_path_factory.mktemp("epilogue_host"),
                                VARIANTS)


def compile_host_kernels(tmp, variants):
    """``csrc/epilogue.cu`` compiled for the host into ``tmp``, once per
    variant of ``variants`` ({name: defines}), loaded with the package's
    signatures: one thread a block (the block's barriers then order
    nothing, and the source uses no warp shuffle), blocks run one after
    another. Misaligned vector and word accesses abort."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to compile the kernel source for the host")
    src = _source()
    assert "constexpr int kThreads = 256;" in src
    assert len(_LAUNCH.findall(src)) == 2  # the design's and the baseline's
    src = _LAUNCH.sub(_LOOP, src.replace("constexpr int kThreads = 256;",
                                         "constexpr int kThreads = 1;"))
    (tmp / "cuda_runtime.h").write_text(_SHIM)
    (tmp / "epilogue_host.cpp").write_text(src)
    procs = {}
    for name, defines in variants.items():
        lib_path = tmp / f"libepilogue_host_{name}.so"
        procs[name] = (lib_path, subprocess.Popen(
            ["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
             "-fsanitize=alignment", "-fsanitize-undefined-trap-on-error",
             f"-I{tmp}", *(f"-D{d}" for d in defines), "-o", str(lib_path),
             str(tmp / "epilogue_host.cpp")], stderr=subprocess.PIPE))
    libs = {}
    for name, (lib_path, proc) in procs.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, err.decode()
        lib = ctypes.CDLL(str(lib_path))
        for entry in ("rjt_epilogue", "rjt_epilogue_load_levels",
                      "rjt_epilogue_table_images"):
            fn = getattr(lib, entry)
            fn.argtypes = build.SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


@pytest.fixture
def host_kernel(host_kernels):
    return host_kernels["default"]


def _kernel_route(lib, css, planes, w, h, fmt, crop, dests=None):
    """The wrapper's kernel route on CPU tensors with the host-compiled
    kernel (``render`` itself takes it for CUDA tensors only)."""
    css, roi = epilogue._check_inputs(css, planes, w, h, crop)
    mode, channels = epilogue.channel_plan(css, fmt, roi[0], roi[1])
    if dests is not None:
        epilogue._check_dests(dests, channels, planes[0].shape[0],
                              planes[0].device)
    return epilogue._render_kernel(lib, None, css, planes, roi, mode,
                                   channels, dests)


KERNEL_CASES = [(variant, css, fmt) for variant in VARIANTS
                for css in FACTORS for fmt in F]


@pytest.mark.parametrize(
    "variant,css,fmt", KERNEL_CASES,
    ids=[("" if v == "default" else v + "-") + f"{c.name[4:]}-{f.name}"
         for v, c, f in KERNEL_CASES])
def test_kernel_source_matches_plain_version(host_kernels, monkeypatch,
                                             variant, css, fmt):
    """Full frame and odd ROI of an odd picture, a batch wider than the
    destination table, pitched destinations at every alignment: one launch
    per table of images, for the computed and the crop-only channels of a
    render into destinations alike."""
    monkeypatch.setattr(epilogue, "launches", 0)
    lib = host_kernels[variant]
    w, h = 51, 35
    step = lib.rjt_epilogue_table_images()
    planes = _torch(_planes(css, w, h, batch=step + 3, seed=11))
    expected = 0
    for name in ("full", "odd"):
        crop = CROPS[name]
        if _yuyv_refused(css, fmt, w, crop):
            crop = CROPS["odd-even-w"] if crop is not None else \
                CropRectangle(0, 0, 50, 35)
        want = epilogue.render_reference(css, planes, w, h, fmt, crop)
        got = _kernel_route(lib, css, planes, w, h, fmt, crop)
        for (a, pa), (b, pb) in zip(got, want):
            assert pa == pb and torch.equal(a, b)
        mode, plan = epilogue.channel_plan(css, fmt, *(
            (w, h) if crop is None else (crop.width, crop.height)))
        # Two launches a render for a batch of step + 3, none for views.
        expected += 2 * (mode is not None)
        if variant == "baseline" and any(ch.plane is not None for ch in plan):
            continue  # the first version computes; it copies no channel
        np_want = [(a.numpy(), p) for a, p in want]
        dests = _alloc_dests(np_want, 13, step + 3)
        for i, d in enumerate(dests):  # every base alignment modulo 16
            for ci in range(len(want)):
                d.channel[ci] = d.channel[ci][i % 3:]
        assert _kernel_route(lib, css, planes, w, h, fmt, crop,
                             dests) is None
        _check_dests(dests, np_want)
        expected += 2  # crop-only channels ride in the same launches
    assert epilogue.launches == expected


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_kernel_source_rows_wider_than_a_tile(host_kernels, variant):
    planes = _torch(_planes(CSS.CSS_420, 4500, 16, batch=1, seed=3))
    for fmt in F:
        for crop in (None, CropRectangle(7, 3, 2407, 15)):
            want = epilogue.render_reference(CSS.CSS_420, planes, 4500, 16,
                                             fmt, crop)
            got = _kernel_route(host_kernels[variant], CSS.CSS_420, planes,
                                4500, 16, fmt, crop)
            for (a, _), (b, _) in zip(got, want):
                assert torch.equal(a, b)


def _expected_load_levels(css, fmt, left, eff_w, eff_h):
    """How each part of a render into destinations loads (2 bits a part,
    ``epilogue.last_load_levels``). The planes here are MCU-padded and their
    storage is 64-byte aligned, so the ROI's left edge decides between
    8-byte (4-byte) loads and shifted words."""
    hf, _vf = FACTORS[css]
    mode, plan = epilogue.channel_plan(css, fmt, eff_w, eff_h)
    c_left = left // hf
    luma = 2 if left % 8 == 0 else 1
    chroma8 = 2 if c_left % 8 == 0 else 1
    levels = 0
    if not any(ch.plane is None and ch.rows and ch.row_bytes for ch in plan):
        mode = None  # nothing to compute (an empty chroma plane)
    if mode == epilogue.MODE_UV:
        levels = chroma8
    elif mode is not None and css == CSS.CSS_400:
        levels = luma
    elif mode is not None:
        levels = min(luma, 2 if c_left % (4 if hf == 2 else 8) == 0 else 1)
    for ci, ch in enumerate(plan):
        if ch.plane is not None and ch.rows and ch.row_bytes:
            levels |= (luma if ch.plane == 0 else chroma8) << (2 + 2 * ci)
    return levels


# Widths on both sides of a word, of a thread's group of 8, of a 16-byte
# store and of a tile (2048 columns, 4096 for planar RGB and for launches of
# copies only; a wider row is cut into tiles of equal width, a multiple of
# 16).
WIDTHS = (1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 2047, 2048, 2049,
          2079, 2080, 2081)
WIDTHS_WIDE_TILE = (4096, 4097, 4130)
LEFTS = (*range(9), 16)
ALIGN_CASES = [(css, fmt, left) for css in FACTORS for fmt in F
               for left in LEFTS]


@pytest.mark.parametrize(
    "css,fmt,left", ALIGN_CASES,
    ids=[f"{c.name[4:]}-{f.name}-left{x}" for c, f, x in ALIGN_CASES])
def test_kernel_source_alignment_matrix(host_kernels, monkeypatch, css, fmt,
                                        left):
    """Every ROI width of WIDTHS (and WIDTHS_WIDE_TILE) at this left edge, odd
    and even top, into destinations at all 16 misalignments (one image
    each): bytes equal to the plain version and to the JAX package, slack untouched, one launch a
    render, and the source loaded 8 bytes at a time exactly where the left
    edge allows it and in shifted words elsewhere. The variant built without
    word loads takes the same cases byte by byte."""
    batch, h = 16, 7
    mode, _plan = epilogue.channel_plan(css, fmt, 64, 64)
    widths = WIDTHS + (WIDTHS_WIDE_TILE
                       if mode in (None, epilogue.MODE_RGB_PLANAR) else ())
    pw = left + max(widths)
    np_planes = _planes(css, pw, h + 2, batch=batch, seed=left)
    planes = _torch(np_planes)
    for w in widths:
        for top in (0, 1):
            eff_h = h if w < 64 else 3
            if css == CSS.CSS_422 and fmt == F.NATIVE and w % 2:
                continue  # packed YUYV has no odd width
            crop = CropRectangle(left, top, left + w, top + eff_h)
            want = epilogue.render_reference(css, planes, pw, h + 2, fmt, crop)
            if w in (5, 2049):
                _assert_same(want, _jax_render(css, np_planes, pw, h + 2, fmt,
                                               crop))
            np_want = [(a.numpy(), p) for a, p in want]
            nonempty = any(a.size for a, _ in np_want)
            for variant in ("default", "steps-off"):
                dests = _alloc_dests(np_want, 21, batch, spare=19)
                for i, d in enumerate(dests):
                    for ci in range(len(want)):
                        d.channel[ci] = d.channel[ci][i:]
                        assert d.channel[ci].data_ptr() % 16 == i
                monkeypatch.setattr(epilogue, "launches", 0)
                monkeypatch.setattr(epilogue, "last_load_levels", None)
                assert _kernel_route(host_kernels[variant], css, planes, pw,
                                     h + 2, fmt, crop, dests) is None
                _check_dests(dests, np_want)
                assert epilogue.launches == int(nonempty)
                if nonempty:
                    assert epilogue.last_load_levels == (
                        _expected_load_levels(css, fmt, left, w, eff_h)
                        if variant == "default" else 0)


def _odd_based(t):
    """The same values in storage that starts one byte past a word."""
    if t is None:
        return None
    buf = torch.empty(t.numel() + 1, dtype=torch.uint8)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


@pytest.mark.parametrize("css,fmt", [(c, f) for c in FACTORS for f in F],
                         ids=lambda x: x.name.replace("CSS_", ""))
def test_kernel_source_planes_not_of_whole_words(host_kernel, monkeypatch,
                                                 css, fmt):
    """Planes whose storage starts at an odd address cannot be loaded in
    words, aligned or shifted: every part loads bytes."""
    w, h = 46, 19
    planes = tuple(_odd_based(t) for t in _torch(_planes(css, w, h, seed=4)))
    assert planes[0].data_ptr() % 4 == 1 and planes[0].is_contiguous()
    for crop in (None, CropRectangle(8, 2, 42, 17)):
        want = [(a.numpy(), p) for a, p in
                epilogue.render_reference(css, planes, w, h, fmt, crop)]
        dests = _alloc_dests(want, 9, planes[0].shape[0])
        monkeypatch.setattr(epilogue, "last_load_levels", None)
        assert _kernel_route(host_kernel, css, planes, w, h, fmt, crop,
                             dests) is None
        _check_dests(dests, want)
        assert epilogue.last_load_levels == 0


@pytest.mark.parametrize("css", list(FACTORS), ids=lambda c: c.name[4:])
def test_copy_channels_take_one_launch_a_table(host_kernel, monkeypatch, css):
    """A render into destinations launches once per 32 images whatever the
    format, crop-only channels included (no copy per image), skips what an
    image left out, and launches nothing when no image wants anything."""
    step = host_kernel.rjt_epilogue_table_images()
    assert step == 32
    w, h = 40, 22
    planes = _torch(_planes(css, w, h, batch=step + 1, seed=2))
    crop = CropRectangle(2, 1, 36, 20)
    for fmt in F:
        want = [(a.numpy(), p) for a, p in
                epilogue.render_reference(css, planes, w, h, fmt, crop)]
        dests = _alloc_dests(want, 5, step + 1)
        left_out = [dests[3].channel[ci] for ci in range(1, len(want))]
        for ci in range(1, len(want)):
            dests[3].channel[ci] = None
        monkeypatch.setattr(epilogue, "launches", 0)
        assert _kernel_route(host_kernel, css, planes, w, h, fmt, crop,
                             dests) is None
        assert epilogue.launches == 2
        _check_dests(dests, want)
        assert all(bool((t == 0xA5).all()) for t in left_out)
    # The last image, alone in its table, wants nothing: that table is not
    # launched.
    fmt = F.YUV_PLANAR if css != CSS.CSS_400 else F.Y
    want = [(a.numpy(), p) for a, p in
            epilogue.render_reference(css, planes, w, h, fmt, crop)]
    dests = _alloc_dests(want, 0, step + 1)
    dests[step].channel = [None] * len(dests[step].channel)
    monkeypatch.setattr(epilogue, "launches", 0)
    channels = epilogue.channel_plan(css, fmt, crop.width, crop.height)[1]
    roi = (crop.width, crop.height, crop.left, crop.top)
    assert epilogue._render_kernel(host_kernel, None, css, planes, roi, None,
                                   channels, dests) is None
    assert epilogue.launches == 1


@pytest.mark.parametrize("what", ["mode", "main-channel", "copy-of-computed",
                                  "copy-without-chroma", "copies-only-none",
                                  "level-not-allowed", "yuyv-odd-width",
                                  "baseline-copy"])
def test_entry_point_refuses(host_kernels, what):
    """The C entry point returns cudaErrorInvalidValue (1 in the host
    build) for what the kernel does not take, before any launch."""
    lib = host_kernels["baseline" if what == "baseline-copy" else "default"]
    y, u, v = _torch(_planes(CSS.CSS_422, 64, 16, batch=1))
    out = torch.zeros(3 * 64 * 16, dtype=torch.uint8)
    ptrs = np.array([[out.data_ptr(), 0, 0]], np.int64)
    pitches = np.array([[192, 0, 0]], np.int64)
    copies = np.full(3, -1, np.int32)
    a = dict(mode=epilogue.MODE_RGB, u=u.data_ptr(), v=v.data_ptr(), left=0,
             cols=64, main_chan=0, levels=0)
    if what == "mode":
        a["mode"] = 5
    elif what == "main-channel":
        a.update(mode=epilogue.MODE_RGB_PLANAR, main_chan=1)
    elif what == "copy-of-computed":
        copies[0] = 0
    elif what == "copy-without-chroma":
        a.update(u=None, v=None)
        copies[1] = 1
    elif what == "copies-only-none":
        a["mode"] = epilogue.MODE_COPY
    elif what == "level-not-allowed":
        a.update(left=3, levels=2)
    elif what == "yuyv-odd-width":
        a.update(mode=epilogue.MODE_YUYV, cols=63)
    else:
        copies[1] = 1

    def call():
        return lib.rjt_epilogue(
            a["mode"], y.data_ptr(), a["u"], a["v"], 16 * 64, 16 * 32, 64, 32,
            0, a["left"], 0, a["left"] // 2, 16, a["cols"] - a["left"],
            (a["cols"] - a["left"]) // 2, 16,
            1, 0, 0, 1, a["main_chan"], a["levels"], copies.ctypes.data,
            ptrs.ctypes.data, pitches.ctypes.data, None)

    assert call() == 1
    assert not out.any()
    if what == "level-not-allowed":  # the same launch in shifted words
        a["levels"] = 1
        assert call() == 0 and out.any()
