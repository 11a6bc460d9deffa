#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--trace-dir DIR] [--soak-secs S]
    python3 chip_smoke.py --only {fuzz,soak,large}
    python3 chip_smoke.py --multi-card

Builds the port's native host library and C ABI with g++ and its CUDA kernels (K1
wave entropy decode, K2 transform, K3 output epilogue) with nvcc from this
checkout, holds each kernel against its plain PyTorch version on the card
(K1 once as the package launches it and once with each of its two flushes
forced, so that both meet every hazard case at a small size; K3 on every
subsampling and format, odd ROIs, an odd picture, a batch wider than its
destination table, pitched caller destinations at every address modulo 16,
and ROI left edges that allow 8-byte loads or force shifted words), then
drives the main path —
``rocjpeg_tpu_torch.api.Decoder().decode_batched`` — over 8 frames of
3840x2160 4:2:0, once with restart markers (real restart lanes, NATIVE
then RGB) and once without (DRI=0, virtual-restart lanes), and checks two
images of each byte for byte against an independent numpy decode
(``rocjpeg_tpu_torch.core.golden``). One more warm call per format
runs under torch.profiler and splits its time by the pipeline's stage
ranges (host) and by kind of device work, with the device's idle share.
``decode_into`` then writes RGB and NV12 into pitched CUDA tensors (one K3
launch a chunk, crop-only channels copied by the same launch). The
user-facing entry points follow on the same frames: the three sample CLIs
(``rocjpeg_tpu_torch.tools``) in this process, the C ABI library
``librocjpeg_tpu_torch.so`` (built by g++ beside the kernels) through ctypes
in this process, and its two C samples as processes of their own; their
files are checked byte for byte against the numpy decode. Each of those
phases must launch every kernel. The multi-device layer (``dist/``) runs on
the same frames: ``MeshDecoder`` over ``make_mesh()`` and over ``cuda:0``
twice (two rows, two threads, one card), ``decode_batched`` and
``decode_batched_local``, every byte against the numpy decode, timed in
turns with ``Decoder`` (``[dist]``); ``jpegdecodeperf --mesh``; two
processes on the card joined by gloo, each decoding its strided half of the
files and reducing the metrics. ``[spec]`` decodes the restart frames
repeated to 32 at chunk widths 4, 8, 16 and 32. One frame of 4097x2161
goes through both paths, and one call of four chunks runs at in-flight
depths 1, 2 and 4. Hostile and very large inputs follow: ``[fuzz]``
holds ``Decoder`` on the card against ``Decoder(device="cpu")`` on the
fuzz suite's truncated, bit-flipped and garbage blobs and on the soak's
first batches (``testing.hostile``; status names, failed indices and bytes,
with the error check on and off) and times a group that mixes restart and
DRI=0 frames; ``[soak]`` runs the soak for ``--soak-secs``; ``[large]``
decodes 7680x4320 frames alone and 32 to a call, and 32 frames of
9504x6336, which must split into chunks of 23 and 9 to stay within K1's
32-bit addressing. ``--only`` runs one of these three alone after the
build (``fuzz`` after the K1 checks), as under ``compute-sanitizer``.
Each kernel is then timed alone, by CUDA
events around ten calls queued back to back, at both groups' shapes, beside
the least time the card could take for the same bytes; K3 also for planar
RGB, packed YUYV and NV12 into destinations on random planes. Every phase
succeeds or raises; the script catches nothing. It imports nothing of jax
or of the JAX package. Timings printed are informational, not gates.

Needs one CUDA device; exits non-zero without one. Synthesized corpora are
cached under build/rjt_bench_corpus (override with BENCH_CORPUS_CACHE).
The last stdout line is the JSON result.
"""

import concurrent.futures
import contextlib
import ctypes
import functools
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_IMAGES = 8
WIDTH, HEIGHT = 3840, 2160
ODD_FRAME = (4097, 2161)  # neither a multiple of the 16 x 16 MCU
HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet
# Device cycles the card spins before a timed run of queued calls (about 4
# ms): the host's head start.
HEAD_START_CYCLES = 8_000_000
# K1 picks its flush from the lane count; RJT_WAVE_FLUSH forces one (1: each
# thread stores its own tile, 2: the warp stores together).
K1_FLUSHES = (1, 2)


def log(msg):
    print(msg, flush=True)


def phase_environment(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}; device {torch.cuda.get_device_name(0)}")
    return card


def _timed_call(fn):
    t0 = time.perf_counter()
    return fn(), time.perf_counter() - t0


def phase_build():
    from rocjpeg_tpu_torch.kernels import build
    from rocjpeg_tpu_torch.runtime import build as host_build
    t0 = time.perf_counter()
    path = host_build.build()
    log(f"[build] host library g++: {time.perf_counter() - t0:.1f} s "
        f"({path})")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:  # one nvcc each
        capi = pool.submit(_timed_call, host_build.build_capi)
        forced = {f: pool.submit(build.load, (f"RJT_WAVE_FLUSH={f}",))
                  for f in K1_FLUSHES}
        build.library()
        forced = {f: fut.result() for f, fut in forced.items()}
        capi_dir, capi_s = capi.result()
    log(f"[build] K1+K2+K3 nvcc sm_90a, and K1 with each flush forced: "
        f"{time.perf_counter() - t0:.1f} s ({build.library_path()})")
    log(f"[build] C ABI {host_build.CAPI_LIBRARY} and samples "
        f"{', '.join(host_build.CAPI_SAMPLES)} g++: {capi_s:.1f} s "
        f"({capi_dir})")
    with open(build.library_path() + ".ptxas.txt") as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            used = next((x.split(":", 1)[1].strip() for x in lines[i + 1:i + 4]
                         if "Used" in x), "?")
            log(f"[build] ptxas {name}: {used}")
    check_no_foreign_modules()
    return forced, capi_dir


def check_no_foreign_modules():
    foreign = sorted(m for m in sys.modules if m in ("jax", "rocjpeg_tpu")
                     or m.startswith(("jax.", "jaxlib", "rocjpeg_tpu.")))
    if foreign:
        raise RuntimeError(f"the port imported {foreign}")


def _max_abs(a, b):
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


class Errors:
    """Largest kernel-vs-plain difference seen per kernel."""

    def __init__(self):
        self.max_abs = {"wave": 0, "transform": 0, "epilogue": 0}

    def record(self, name, err):
        self.max_abs[name] = max(self.max_abs[name], err)
        if err:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max abs err {err})")


def _wave_case(torch, plist, errs, virtual_k=None, crop=None, max_steps=None,
               n_lanes=None):
    """K1 against its plain version on one small group: coefficients and
    error flags must be equal (tolerance 0). ``crop`` packs only the MCU
    rows of an ROI, ``max_steps`` overrides the packer's bound, ``n_lanes``
    cuts the padded lane arrays to that many lanes."""
    from rocjpeg_tpu_torch import pipeline
    from rocjpeg_tpu_torch.kernels import wave
    g = pipeline.pack_group(plist, "cuda", crop, virtual_k=virtual_k)
    dp = g.packed
    lanes = [t[:n_lanes] for t in (dp.word_off, dp.img_base, dp.mcu_start,
                                   dp.mcu_count, dp.lane_bank)]
    args = (dp.dense, *lanes, g.lentab, g.values, g.geom, dp.n_words,
            max_steps or g.max_steps)
    out_k, err_k = wave.wave_decode(*args)
    out_p, err_p = wave.wave_decode_reference(*args)
    torch.cuda.synchronize()
    errs.record("wave", int((err_k != err_p).sum().item()))
    errs.record("wave", _max_abs(out_k, out_p))
    return g, out_k, err_k


def _small_streams(css, ri, variants=(0, 0), w=128, h=96):
    from rocjpeg_tpu_torch.core.bitstream import JpegStreamParser
    from rocjpeg_tpu_torch.testing import encoder
    return [JpegStreamParser().parse(encoder.encode_planes(
        encoder.random_planes(css, w, h, seed=s), css,
        restart_interval=ri, table_variant=v))
        for s, v in enumerate(variants)]


def phase_k1_checks(torch, errs):
    from rocjpeg_tpu_torch import CropRectangle
    streams = _small_streams
    for css in ("420", "444"):
        _wave_case(torch, streams(css, 1), errs)
        log(f"[K1] restart lanes {css}: kernel == plain (tolerance 0)")
    _wave_case(torch, streams("420", 0), errs, virtual_k=100)
    log("[K1] virtual lanes 420: kernel == plain")
    g, _, _ = _wave_case(torch, streams("420", 2, variants=(0, 1)), errs)
    assert g.lentab.shape[0] == 8, "expected a 2-bank group"
    log("[K1] 2-bank group: kernel == plain")
    # 24 stuffed 0xFF bytes mid-scan: a run of one-bits no Huffman code has.
    # First one lane per image (DRI=0 packed as a single restart segment):
    # the lane errs early and leaves most of its image to be zero-filled.
    # Then restart lanes, of which a few err mid-block.
    for ri in (0, 2):
        bad = streams("420", ri)
        data = bytearray(bad[0].slice_data)
        if ri == 0:
            data[16:64] = b"\xff\x00" * 24
        else:  # garble payload bytes, keeping the restart markers
            for i in range(16, len(data) - 1):
                if 0xFF not in (data[i - 1], data[i], data[i + 1], data[i] ^ 0x5A):
                    data[i] ^= 0x5A
        bad[0].slice_data = bytes(data)
        _, _, err_k = _wave_case(torch, bad, errs)
        assert bool(err_k.any()), "corrupt scan raised no error flag"
    log("[K1] corrupt scans: coefficients and error flags == plain")
    # An ROI that skips MCU rows at the top and at the bottom: the bands
    # belong to no lane and must come out zero.
    roi = CropRectangle(0, 32, 128, 64)
    for ri, vk in ((1, None), (0, 40)):
        g, out_k, _ = _wave_case(torch, streams("420", ri), errs,
                                 virtual_k=vk, crop=roi)
        covered = int(g.packed.mcu_count.sum().item())
        assert 0 < covered < 2 * 8 * 6, covered
        assert int((out_k != 0).sum().item()) > 0
    log("[K1] ROI packs (restart and virtual lanes): kernel == plain")
    # Lanes cut short by max_steps, mid-block and at a block's end.
    for steps in (3, 20, 61):
        _, _, err_k = _wave_case(torch, streams("420", 4), errs,
                                 max_steps=steps)
        assert bool(err_k.any()), "a cut lane raised no error flag"
    log("[K1] lanes cut by max_steps: kernel == plain")
    # Lane counts that fill no whole thread block: every real lane plus 5
    # of the padding (full cover), then 77 lanes (part of the group).
    real = 2 * 8 * 6
    for n in (real + 5, 77):
        _wave_case(torch, streams("420", 1), errs, n_lanes=n)
    log("[K1] ragged lane counts: kernel == plain")


def phase_k2_checks(torch, errs):
    """K2 on extreme coefficients: int32 and int16 wraparound."""
    import numpy as np
    from rocjpeg_tpu_torch.kernels import transform
    g = _wave_case(torch, _small_streams("420", 0), errs, virtual_k=50)[0]
    rng = np.random.default_rng(7)
    n = g.geom.batch * g.geom.total_blocks * 64
    coeffs = rng.integers(-32768, 32768, n).astype(np.int16)
    coeffs[rng.random(n) < 0.3] = 32767
    coeffs[rng.random(n) < 0.3] = -32767
    quant = rng.integers(1, 256, (g.geom.batch, 3, 64)).astype(np.int32)
    dc = g.packed.dc_flat
    dc_big = torch.from_numpy(rng.integers(
        -2 ** 31, 2 ** 31, tuple(dc.shape)).astype(np.int32)).cuda()
    args = (torch.from_numpy(coeffs).cuda(), torch.from_numpy(quant).cuda(),
            g.geom)
    for fix in ((), (dc_big, g.packed.lane_of_mcu)):
        out_k = transform.transform(*args, *fix)
        out_p = transform.transform_reference(*args, *fix)
        torch.cuda.synchronize()
        for a, b in zip(out_k, out_p):
            errs.record("transform", _max_abs(a, b))
    log("[K2] extreme coefficients, with and without DC fixup: "
        "kernel == plain")


def _random_planes(torch, css, w, h, batch, seed):
    """MCU-padded random uint8 planes (y, u, v) on the card."""
    import numpy as np
    from rocjpeg_tpu_torch.ops.postprocess import CHROMA_FACTORS
    rng = np.random.default_rng(seed)
    hf, vf = CHROMA_FACTORS.get(css, (1, 1))
    pw, ph = -(-w // (8 * hf)) * 8 * hf, -(-h // (8 * vf)) * 8 * vf
    shapes = [(batch, ph, pw)] + [(batch, ph // vf, pw // hf)] * 2
    planes = [torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8)).cuda()
              for s in shapes]
    return tuple(planes) if css.name != "CSS_400" else (planes[0], None, None)


SLACK_FILL = 0xA5


def _pitched_dests(torch, channels, slack, base=2):
    """One caller destination per image for batched (tensor, pitch)
    channels: flat CUDA buffers pre-filled with SLACK_FILL, ``slack`` bytes
    of pitch past each row, image i's starting i mod ``base`` bytes past
    an aligned address (an odd address on odd images)."""
    from rocjpeg_tpu_torch import DecodedImage
    dests = []
    for i in range(channels[0][0].shape[0]):
        d = DecodedImage.empty()
        for ci, (arr, _pitch) in enumerate(channels):
            pitch = arr.shape[2] + slack
            d.channel[ci] = torch.full((arr.shape[1] * pitch + base,),
                                       SLACK_FILL, dtype=torch.uint8,
                                       device="cuda")[i % base:]
            d.pitch[ci] = pitch
        dests.append(d)
    return dests


def _check_pitched(torch, dest, ci, want, what):
    """Rows equal ``want`` (rows, row_bytes), every other byte untouched."""
    rows, row = want.shape
    pitch = dest.pitch[ci]
    buf = dest.channel[ci]
    win = buf[:rows * pitch].view(rows, pitch)
    if not torch.equal(win[:, :row], want):
        raise AssertionError(f"{what}: channel {ci} differs")
    if not (bool((win[:, row:] == SLACK_FILL).all())
            and bool((buf[rows * pitch:] == SLACK_FILL).all())):
        raise AssertionError(f"{what}: channel {ci} slack bytes were written")


def phase_k3_checks(torch, errs):
    """K3 against its plain version at a small size, tolerance 0: every
    subsampling and format; the full frame and ROIs with odd left, top,
    width and height, of an even and an odd picture; a batch wider than
    the kernel's destination table; pitched caller destinations whose
    slack must come back untouched, written by one launch per table of
    images whether a channel is computed or a crop (no copy per image)."""
    from rocjpeg_tpu_torch import (ChromaSubsampling, CropRectangle,
                                   OutputFormat)
    from rocjpeg_tpu_torch.kernels import build, epilogue
    table = build.library().rjt_epilogue_table_images()
    wide = table + 3
    n = computed = 0
    for css in ChromaSubsampling:
        if css.name in ("CSS_411", "CSS_UNKNOWN"):
            continue
        for w, h, batch in ((64, 48, 2), (131, 97, 2), (50, 34, wide)):
            planes = _random_planes(torch, css, w, h, batch, seed=n)
            for fmt in OutputFormat:
                yuyv = css.name == "CSS_422" and fmt == OutputFormat.NATIVE
                crops = [None if not (yuyv and w % 2)
                         else CropRectangle(0, 0, w - 1, h),
                         CropRectangle(3, 5, 36 + yuyv, 28),
                         CropRectangle(1, 1, 4 + yuyv, 4)]
                for crop in crops:
                    before = epilogue.launches
                    got = epilogue.render(css, planes, w, h, fmt, crop)
                    computed += epilogue.launches > before
                    want = epilogue.render_reference(css, planes, w, h, fmt,
                                                     crop)
                    assert len(got) == len(want)
                    for (a, pa), (b, pb) in zip(got, want):
                        assert pa == pb and a.shape == b.shape, (
                            css, fmt, crop, pa, pb, a.shape, b.shape)
                        errs.record("epilogue", _max_abs(a, b))
                    _k3_into_dests(torch, epilogue, css, planes, w, h, fmt,
                                   crop, want, 13, -(-batch // table))
                    n += 1
    log(f"[K3] {n} cases (5 subsamplings x 5 formats x full frame and odd "
        f"ROIs, pictures 64x48, 131x97 and a batch of {wide}), {computed} "
        "with computed channels: kernel == plain (tolerance 0), into its "
        "own tensors and into pitched destinations with the slack "
        "untouched, one launch per table of images for computed and "
        "crop-only channels alike")


def _k3_into_dests(torch, epilogue, css, planes, w, h, fmt, crop, want, slack,
                   launches, base=2):
    """One render into pitched destinations (image i's buffers start i mod
    ``base`` bytes past an aligned address): ``launches`` launches, rows
    equal to ``want``, slack untouched."""
    dests = _pitched_dests(torch, want, slack, base)
    before = epilogue.launches
    assert epilogue.render(css, planes, w, h, fmt, crop, dests) is None
    assert epilogue.launches - before == launches, (
        css, fmt, crop, epilogue.launches - before, launches)
    torch.cuda.synchronize()
    for i, d in enumerate(dests):
        for ci, (b, _) in enumerate(want):
            _check_pitched(torch, d, ci, b[i],
                           f"K3 {css.name} {fmt.name} {crop}")


# The alignment matrix of K3 at a reduced size: ROI left edges that allow
# 8-byte loads (0, 16) and that force shifted words (1, 3); widths on both
# sides of a thread's group of 8 and of a tile (2048 columns, 4096 for
# planar RGB).
K3_LEFTS = (0, 1, 3, 16)
K3_WIDTHS = (1, 7, 8, 9, 34, 2050, 4098)


def phase_k3_alignment(torch):
    """K3 into destinations at all 16 misalignments (one image each) over
    K3_LEFTS x K3_WIDTHS x odd and even top, every subsampling and format:
    bytes equal to the plain version, slack untouched, one launch a render,
    and every part of the launch loading as the left edge allows."""
    from rocjpeg_tpu_torch import (ChromaSubsampling, CropRectangle,
                                   OutputFormat)
    from rocjpeg_tpu_torch.kernels import epilogue
    n = 0
    for css in ChromaSubsampling:
        if css.name in ("CSS_411", "CSS_UNKNOWN"):
            continue
        pw, ph = K3_LEFTS[-1] + K3_WIDTHS[-1], 8
        planes = _random_planes(torch, css, pw, ph, 16, seed=int(css))
        for fmt in OutputFormat:
            yuyv = css.name == "CSS_422" and fmt == OutputFormat.NATIVE
            for left in K3_LEFTS:
                for w in K3_WIDTHS:
                    if yuyv and w % 2:
                        continue
                    top = n % 2
                    crop = CropRectangle(left, top, left + w, top + 5)
                    want = epilogue.render_reference(css, planes, pw, ph, fmt,
                                                     crop)
                    if not any(a.numel() for a, _ in want):
                        continue
                    _k3_into_dests(torch, epilogue, css, planes, pw, ph, fmt,
                                   crop, want, 21, 1, base=16)
                    # Every render reads the luma plane in some part; a
                    # chroma plane's own left edge may still be aligned.
                    fields = {(epilogue.last_load_levels >> s) & 3
                              for s in range(0, 8, 2)} - {0}
                    assert min(fields) == (2 if left % 16 == 0 else 1), (
                        css, fmt, crop, epilogue.last_load_levels)
                    n += 1
    log(f"[K3] alignment: {n} renders into 16 destinations each, one at "
        f"every address modulo 16, ROI left edges {K3_LEFTS} x widths "
        f"{K3_WIDTHS} x top 0 / 1, 5 subsamplings x 5 formats: kernel == "
        "plain (tolerance 0), slack untouched, one launch a render, 8-byte "
        "loads at left edges 0 and 16, shifted words at 1 and 3")


@functools.lru_cache(maxsize=None)
def _numpy_ref(blob, fmt):
    """The numpy oracle's channels of one frame, computed once a run (a 4K
    frame costs seconds) and shared by every phase that checks it."""
    from rocjpeg_tpu_torch.core import golden
    return golden.decode(blob, fmt)


def _decode_timed(torch, dec, streams, params, reps=3):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs = dec.decode_batched(streams, params)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return imgs, statistics.median(times)


def phase_main_path(torch, name, blobs, fmts, want_path, trace_dir):
    import numpy as np
    from rocjpeg_tpu_torch import DecodeParams, api
    dec = api.Decoder()
    streams = [api.JpegStream(b) for b in blobs]
    mpix = len(blobs) * WIDTH * HEIGHT / 1e6
    peak, on_device = 0, {}
    for fmt in fmts:
        torch.cuda.reset_peak_memory_stats()
        dec.decode_batched(streams, DecodeParams(fmt))  # warm-up
        imgs, sec = _decode_timed(torch, dec, streams, DecodeParams(fmt))
        fmt_peak = torch.cuda.max_memory_allocated()
        peak = max(peak, fmt_peak)
        paths = [p for p, _ in dec.last_paths]
        assert paths and all(p == want_path for p in paths), paths
        for i in (0, len(blobs) - 1):
            ref = _numpy_ref(blobs[i], fmt)
            for ci, (arr, _pitch) in enumerate(ref):
                got = imgs[i].channel[ci].cpu().numpy()
                if not np.array_equal(got, arr):
                    raise AssertionError(
                        f"{name} {fmt.name}: image {i} channel {ci} differs "
                        "from the numpy reference")
        log(f"[main] {name} {fmt.name}: paths {sorted(set(paths))}, 2 images "
            f"byte-equal to numpy; warm decode {sec * 1e3:.1f} ms, "
            f"{mpix / sec:.1f} Mpix/s, peak device memory "
            f"{fmt_peak / 2 ** 20:.1f} MiB (informational)")
        del imgs
        on_device[fmt] = stage_split(
            torch, f"{name} {fmt.name}",
            lambda: dec.decode_batched(streams, DecodeParams(fmt)), trace_dir)
    dec.synchronize()
    return peak, on_device


def phase_decode_into(torch, name, blobs, want_path, on_device):
    """``decode_into`` of the whole corpus into pitched CUDA tensors, as RGB
    and as NATIVE (NV12: K3 copies Y and computes UV through the caller's
    pointers): two images byte-equal to numpy, slack untouched, one K3
    launch a chunk, and nothing on the device that ``decode_batched`` of
    the same format did not run (``on_device``: its kernels' names), so no
    copy per image."""
    from rocjpeg_tpu_torch import DecodeParams, OutputFormat, api
    from rocjpeg_tpu_torch.kernels import epilogue
    dec = api.Decoder()
    streams = [api.JpegStream(b) for b in blobs]
    n = len(blobs)
    shapes = {OutputFormat.RGB: [(HEIGHT, 3 * WIDTH)],
              OutputFormat.NATIVE: [(HEIGHT, WIDTH), (HEIGHT // 2, WIDTH)]}
    for fmt, chans in shapes.items():
        dests = _pitched_dests(
            torch, [(torch.empty((n, *c), device="meta"), c[1])
                    for c in chans], 64)
        before = epilogue.launches
        dec.decode_into(streams, dests, DecodeParams(fmt))
        dec.synchronize()
        paths = [p for p, _ in dec.last_paths]
        assert paths and all(p == want_path for p in paths), paths
        assert epilogue.launches - before == len(paths), (
            epilogue.launches - before, paths)
        ran = stage_split(
            torch, f"{name} decode_into {fmt.name}",
            lambda: dec.decode_into(streams, dests, DecodeParams(fmt)), None)
        same_work = ""
        if fmt in on_device:
            if ran - on_device[fmt]:
                raise AssertionError(
                    f"decode_into {fmt.name} ran {ran - on_device[fmt]}, "
                    "which decode_batched does not")
            same_work = "no device work that decode_batched does not do, "
        for i in (0, n - 1):
            for ci, (ref, _pitch) in enumerate(_numpy_ref(blobs[i], fmt)):
                _check_pitched(torch, dests[i], ci,
                               torch.from_numpy(ref).cuda(),
                               f"{name} decode_into {fmt.name} image {i}")
        log(f"[main] {name} decode_into {fmt.name}, pitch row + 64, odd base "
            f"on odd images: paths {sorted(set(paths))}, {len(paths)} K3 "
            f"launch(es) for as many chunks, {same_work}2 images byte-equal "
            "to numpy, slack untouched")


def phase_odd_frame(torch, blob, label, want_path):
    """One frame of odd geometry through decode_batched, NATIVE and RGB,
    against the numpy decode."""
    import numpy as np
    from rocjpeg_tpu_torch import DecodeParams, OutputFormat, api
    from rocjpeg_tpu_torch.core import golden
    dec = api.Decoder(device_entropy="on")
    for fmt in (OutputFormat.NATIVE, OutputFormat.RGB):
        img, = dec.decode_batched([api.JpegStream(blob)], DecodeParams(fmt))
        paths = [p for p, _ in dec.last_paths]
        assert paths == [want_path], paths
        for ci, (arr, pitch) in enumerate(golden.decode(blob, fmt)):
            assert img.pitch[ci] == pitch
            if not np.array_equal(img.channel[ci].cpu().numpy(), arr):
                raise AssertionError(f"{label} {fmt.name}: channel {ci} "
                                     "differs from the numpy reference")
        log(f"[odd] {label} {fmt.name}: path {want_path}, byte-equal to "
            "numpy")


def _check_images(images, blobs, fmt, what):
    """Every channel of every image byte-equal to the numpy oracle's,
    pitches equal."""
    import numpy as np
    for i, (img, blob) in enumerate(zip(images, blobs)):
        for ci, (arr, pitch) in enumerate(_numpy_ref(blob, fmt)):
            if img.pitch[ci] != pitch or not np.array_equal(
                    img.channel[ci].cpu().numpy(), arr):
                raise AssertionError(f"{what}: image {i} channel {ci} "
                                     "differs from the numpy reference")


def _numpy_refs(blobs, fmt):
    """The numpy oracle of every frame, on threads (its native entropy
    decode and large numpy operations release the interpreter lock)."""
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(lambda b: _numpy_ref(b, fmt), blobs))


def _in_turns(torch, calls, rounds=3):
    """Warm each call once, then time ``rounds`` rounds of one call each in
    turns (host clock, each call ending in a synchronize of every card;
    peak memory is the current card's). Returns
    {name: (median s, peak device memory of its calls, "t1/t2/t3 ms")}."""
    def sync():  # every card: a mesh's rows may sit on several
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    for fn in calls.values():
        fn()
    times = {name: [] for name in calls}
    peaks = dict.fromkeys(calls, 0)
    for _ in range(rounds):
        for name, fn in calls.items():
            sync()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn()
            sync()
            times[name].append(time.perf_counter() - t0)
            peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated())
            del out
    return {name: (statistics.median(ts), peaks[name],
                   "/".join(f"{t * 1e3:.1f}" for t in ts))
            for name, ts in times.items()}


def phase_dist(torch, corpora, trace_dir):
    """``dist.sharding.MeshDecoder`` over ``make_mesh()`` (every card: one
    row here) and over ``cuda:0`` twice (two rows, two decoders on two
    threads, one card) on both corpora, NATIVE: ``decode_batched`` and
    ``decode_batched_local``, every byte of every image equal to the numpy
    oracle, the channels on the card, shards in batch order, K1-K3
    launched by each mesh's calls. Then warm calls of ``api.Decoder()``,
    both meshes and ``Decoder`` on the two-row mesh's first shard alone, in
    turns (median of 3) with their peak device memory, and one call of the two-row mesh under torch.profiler (its
    stage ranges summed over both rows' threads)."""
    from rocjpeg_tpu_torch import DecodeParams, OutputFormat, api
    from rocjpeg_tpu_torch.dist import mesh, sharding
    from rocjpeg_tpu_torch.kernels import epilogue, transform, wave
    fmt = OutputFormat.NATIVE
    params = DecodeParams(fmt)
    t0 = time.perf_counter()
    for _name, blobs, _path in corpora:
        _numpy_refs(blobs, fmt)
    log(f"[dist] numpy references of the {sum(len(b) for _, b, _ in corpora)}"
        f" frames, NATIVE: {time.perf_counter() - t0:.1f} s")
    meshes = {"mesh over make_mesh()": sharding.MeshDecoder(mesh.make_mesh()),
              "mesh over cuda:0 twice": sharding.MeshDecoder(
                  mesh.make_mesh(devices=["cuda:0", "cuda:0"]))}
    mods = (wave, transform, epilogue)
    dec = api.Decoder()
    for name, blobs, want_path in corpora:
        streams = [api.JpegStream(b) for b in blobs]
        n = len(streams)
        for label, md in meshes.items():
            rows = md.mesh.shape["data"]
            before = [m.launches for m in mods]
            imgs = md.decode_batched(streams, params)
            md.synchronize()
            paths = md.last_paths
            assert [p for p, _ in paths] == [want_path] * rows, paths
            per = -(-n // rows)
            assert [list(i) for _, i in paths] == [
                list(range(lo, min(lo + per, n))) for lo in range(0, n, per)]
            assert all(img.channel[0].device == torch.device("cuda", 0)
                       for img in imgs)
            _check_images(imgs, blobs, fmt, f"[dist] {label} {name}")
            del imgs
            local, pitches, err = md.decode_batched_local(streams, params)
            assert not err.any() and len(local) == n
            launched = [m.launches - b for m, b in zip(mods, before)]
            assert all(k >= 2 * rows for k in launched), launched
            for i, (chans, blob) in enumerate(zip(local, blobs)):
                ref = _numpy_ref(blob, fmt)
                assert pitches == [p for _, p in ref], pitches
                for ci, (arr, _pitch) in enumerate(ref):
                    if not (chans[ci].shape == arr.shape
                            and (chans[ci] == arr).all()):
                        raise AssertionError(
                            f"[dist] {label} {name} decode_batched_local: "
                            f"image {i} channel {ci} differs from numpy")
            log(f"[dist] {label} ({rows} row(s)) {name} NATIVE: paths "
                f"{sorted(set(p for p, _ in paths))}, shards "
                f"{[len(i) for _, i in paths]}, launches (K1, K2, K3) "
                f"{launched}; decode_batched and decode_batched_local: all "
                f"{n} images byte-equal to numpy")
        calls = {"Decoder": lambda: dec.decode_batched(streams, params)}
        calls.update({label: lambda md=md: md.decode_batched(streams, params)
                      for label, md in meshes.items()})
        # What one of the two rows does, alone: the first half.
        calls["Decoder on one shard of the two"] = (
            lambda: dec.decode_batched(streams[:-(-n // 2)], params))
        res = _in_turns(torch, calls)
        two = meshes["mesh over cuda:0 twice"]
        stage_split(torch, f"{name} NATIVE mesh over cuda:0 twice",
                    lambda: two.decode_batched(streams, params), trace_dir)
        frames = dict.fromkeys(calls, n)
        frames["Decoder on one shard of the two"] = -(-n // 2)
        log(f"[dist] {name} NATIVE, warm calls in turns (median of 3): "
            + "; ".join(f"{label} {sec * 1e3:.1f} ms ({each}), "
                        f"{frames[label] * WIDTH * HEIGHT / 1e6 / sec:.1f} "
                        f"Mpix/s, peak device memory {peak / 2 ** 20:.1f} MiB"
                        for label, (sec, peak, each) in res.items())
            + " (informational)")
    for md in meshes.values():
        md.synchronize()
        md.close()


def phase_spec(torch, blobs, widths=(4, 8, 16, 32)):
    """The restart frames repeated to 32 (the same bytes) through
    ``Decoder(spec=GpuDecodeSpec(num_decode_lanes=w))`` at each chunk
    width, NATIVE, in turns (median of 3): time and peak device memory,
    the first and last image byte-equal to numpy."""
    from rocjpeg_tpu_torch import (DecodeParams, GpuDecodeSpec, OutputFormat,
                                   api)
    fmt = OutputFormat.NATIVE
    streams = [api.JpegStream(b) for b in blobs] * 4
    params = DecodeParams(fmt)
    decs = {w: api.Decoder(spec=GpuDecodeSpec(name=f"{w} lanes",
                                              num_decode_lanes=w))
            for w in widths}
    for w, dec in decs.items():
        imgs = dec.decode_batched(streams, params)
        dec.synchronize()
        assert len(dec.last_paths) == -(-len(streams) // w), dec.last_paths
        _check_images([imgs[0], imgs[-1]], [blobs[0], blobs[-1]], fmt,
                      f"[spec] {w} lanes")
        del imgs
    res = _in_turns(torch, {w: (lambda d=dec: d.decode_batched(streams,
                                                               params))
                            for w, dec in decs.items()})
    mpix = len(streams) * WIDTH * HEIGHT / 1e6
    for w, (sec, peak, each) in res.items():
        log(f"[spec] {len(streams)} restart frames NATIVE in chunks of {w}: "
            f"{sec * 1e3:.1f} ms ({each}), {mpix / sec:.1f} Mpix/s, peak "
            f"device memory {peak / 2 ** 20:.1f} MiB (median of 3, in "
            "turns)")
    log(f"[spec] spec_for_device on this card: "
        f"{api.Decoder().spec.num_decode_lanes} lanes")


MULTI_CARD_DIR = os.path.join(ROOT, "build", "rjt_smoke_cards")


def phase_multi_card(torch, restart, dri0, copies=4):
    """Every card of the machine (two or more). (1) The kernel wrappers'
    device guard: a thread whose current device is cuda:0 decodes on the
    last card, once on that card's default stream and once on a side
    stream of it, both byte-equal to numpy with the channels on that card.
    (2) ``MeshDecoder`` over ``make_mesh()`` (a row a card) on each corpus
    repeated ``copies`` times: every image byte-equal to numpy and on its
    row's card, shards in batch order; warm calls in turns beside
    ``Decoder`` on cuda:0 and a mesh of as many rows on cuda:0 alone.
    (3) One process a card joined by NCCL (``multihost.initialize``'s
    default on CUDA), each decoding its strided share of the restart files
    with ``decode_batched_local`` and reducing the metrics."""
    import hashlib
    import threading
    from rocjpeg_tpu_torch import DecodeParams, OutputFormat, api
    from rocjpeg_tpu_torch.dist import mesh, sharding
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        raise SystemExit("chip_smoke --multi-card needs two or more cards")
    fmt = OutputFormat.NATIVE
    params = DecodeParams(fmt)
    _numpy_refs(restart + dri0, fmt)
    last = torch.device("cuda", n_cards - 1)
    dec_last = api.Decoder(device=last)
    streams = [api.JpegStream(b) for b in restart]

    def off_card(side, errors):
        try:
            assert torch.cuda.current_device() == 0
            if side:  # the last card's current stream on this thread
                torch.cuda.set_stream(torch.cuda.Stream(device=last))
                torch.cuda.set_device(0)
            imgs = dec_last.decode_batched(streams, params)
            dec_last.synchronize()
            assert all(img.channel[0].device == last for img in imgs)
            _check_images(imgs, restart, fmt, f"[cards] decode on {last} "
                          f"from a thread on cuda:0 (side stream {side})")
        except BaseException as exc:  # reported by the calling thread
            errors.append(exc)

    for side in (False, True):
        errors = []
        worker = threading.Thread(target=off_card, args=(side, errors))
        worker.start()
        worker.join(timeout=300)
        assert not worker.is_alive(), "the off-card decode hung"
        if errors:
            raise errors[0]
    log(f"[cards] {n_cards} cards; a thread on cuda:0 decodes on {last} "
        "(its default stream, then a side stream of it): channels on "
        f"{last}, {len(restart)} images byte-equal to numpy each time")

    every = sharding.MeshDecoder(mesh.make_mesh())
    one = sharding.MeshDecoder(mesh.make_mesh(devices=[0] * n_cards))
    dec = api.Decoder()
    for name, blobs in (("restart", restart), ("dri0", dri0)):
        batch = list(blobs) * copies
        streams = [api.JpegStream(b) for b in batch]
        imgs = every.decode_batched(streams, params)
        every.synchronize()
        per = len(batch) // n_cards
        assert [list(i) for _, i in every.last_paths] == [
            list(range(r * per, (r + 1) * per)) for r in range(n_cards)]
        for r in range(n_cards):
            assert all(img.channel[0].device == torch.device("cuda", r)
                       for img in imgs[r * per:(r + 1) * per])
        _check_images(imgs, batch, fmt, f"[cards] mesh {name}")
        del imgs
        res = _in_turns(torch, {
            "Decoder on cuda:0": lambda: dec.decode_batched(streams, params),
            f"mesh over {n_cards} cards":
                lambda: every.decode_batched(streams, params),
            f"mesh of {n_cards} rows on cuda:0":
                lambda: one.decode_batched(streams, params)})
        mpix = len(batch) * WIDTH * HEIGHT / 1e6
        log(f"[cards] {name} NATIVE, {len(batch)} frames, all byte-equal "
            f"to numpy on their rows' cards; warm calls in turns (median of "
            "3): " + "; ".join(f"{label} {sec * 1e3:.1f} ms ({each}), "
                               f"{mpix / sec:.1f} Mpix/s"
                               for label, (sec, _peak, each) in res.items())
            + " (informational; peak memory is cuda:0's)")
    for md in (every, one):
        md.close()

    shutil.rmtree(MULTI_CARD_DIR, ignore_errors=True)
    os.makedirs(MULTI_CARD_DIR)
    digests = {}
    for i, blob in enumerate(list(restart) * copies):
        path = os.path.join(MULTI_CARD_DIR, f"{i:03d}.jpg")
        with open(path, "wb") as f:
            f.write(blob)
        digests[path] = hashlib.sha256(b"".join(
            a.tobytes() for a, _ in _numpy_ref(blob, fmt))).hexdigest()
    digests_path = os.path.join(MULTI_CARD_DIR, "digests.json")
    with open(digests_path, "w") as f:
        json.dump(digests, f)
    results, wall = _run_processes(n_cards, digests_path, None)
    shutil.rmtree(MULTI_CARD_DIR)
    images, mpix, sec = results[0]["total"]
    assert images == len(digests) and all(
        r["total"] == results[0]["total"] and r["backend"] == "nccl"
        for r in results), results
    assert sec == max(r["sec"] for r in results), results
    log(f"[cards] {n_cards} processes, one a card, under NCCL: "
        f"{len(digests) // n_cards} files each (decode_batched_local, "
        f"digests equal to numpy's), reduced {int(images)} images, "
        f"{mpix:.1f} Mpix, {sec * 1e3:.1f} ms (the longest process's warm "
        f"call), {mpix / sec:.1f} Mpix/s; processes {wall:.1f} s "
        "(informational)")


CLI_DIR = os.path.join(ROOT, "build", "rjt_smoke_cli")


def _write_frames(d, named):
    os.makedirs(d)
    for name, blob in named:
        with open(os.path.join(d, name + ".jpg"), "wb") as f:
            f.write(blob)
    return d


def _write_cli_corpus(restart, dri0):
    """The smoke's two corpora as files. ``all/``: sorted, the DRI=0 frames
    then the restart frames, so a batch of 8 holds one kind; ``threads/``:
    the same frames named so that sorted order alternates the kinds, so
    each of two threads (files split i::2) takes one kind; ``pair/``: the
    first frame of each."""
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    kinds = (("dri0", dri0), ("restart", restart))
    return {
        "all": _write_frames(os.path.join(CLI_DIR, "all"), [
            (f"{kind}_{i}", b) for kind, blobs in kinds
            for i, b in enumerate(blobs)]),
        "threads": _write_frames(os.path.join(CLI_DIR, "threads"), [
            (f"{i}_{k}_{kind}", b) for k, (kind, blobs) in enumerate(kinds)
            for i, b in enumerate(blobs)]),
        "pair": _write_frames(os.path.join(CLI_DIR, "pair"), [
            ("dri0_0", dri0[0]), ("restart_0", restart[0])]),
    }


def _run_tool(main, argv, decoded):
    """Run a CLI's main in this process; its stdout is returned after the
    return code and the counters are checked (``decoded`` images, none
    skipped)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    if rc != 0 or f"info: total decoded images: {decoded}\n" not in out \
            or "skipped" in out:
        raise AssertionError(f"{argv}: rc {rc}, want {decoded} decoded and "
                             f"none skipped:\n{out}")
    return out


def _rates(out):
    """The images/s and Mpix/s a CLI printed."""
    got = {}
    for line in out.splitlines():
        for key, name in (("avg images per sec:", "images/s"),
                          ("(Mpixels/sec):", "Mpix/s")):
            if key in line:
                got[name] = float(line.rsplit(":", 1)[1])
    return f"{got['images/s']:.2f} images/s, {got['Mpix/s']:.1f} Mpix/s"


def _check_file(path, blob, fmt, what):
    """A raw file a CLI or C sample wrote equals the numpy oracle's tight
    channels of ``blob``."""
    import numpy as np
    with open(path, "rb") as f:
        got = f.read()
    want = b"".join(np.ascontiguousarray(a).tobytes()
                    for a, _pitch in _numpy_ref(blob, fmt))
    if got != want:
        raise AssertionError(f"{what}: {path} differs from the numpy "
                             "reference")


def phase_cli(dirs, restart, dri0):
    """The three sample CLIs in this process on the card: jpegdecode -fmt
    rgb -o on a pair of frames, jpegdecodebatched -b 8 -fmt native -o and
    jpegdecodeperf -t 2 -b 8 -fmt native on the 16 frames. Their counters
    must show every frame decoded and none skipped, and the files they
    save equal the numpy oracle's bytes (the frames it has already
    decoded)."""
    from rocjpeg_tpu_torch import OutputFormat
    from rocjpeg_tpu_torch.tools import (jpegdecode, jpegdecodebatched,
                                         jpegdecodeperf)
    F = OutputFormat
    size = f"{WIDTH}x{HEIGHT}"
    out = os.path.join(CLI_DIR, "out") + os.sep
    os.makedirs(out)
    res = _run_tool(jpegdecode.main,
                    ["-i", dirs["pair"], "-fmt", "rgb", "-o", out], 2)
    for kind, blob in (("dri0", dri0[0]), ("restart", restart[0])):
        _check_file(f"{out}{kind}_0_{size}_packed.rgb", blob, F.RGB,
                    "jpegdecode -fmt rgb")
    log(f"[cli] jpegdecode -fmt rgb -o, 2 frames (one a call): rc 0, 2 "
        f"decoded, 0 skipped, both files byte-equal to numpy; {_rates(res)} "
        "(informational)")
    res = _run_tool(jpegdecodebatched.main,
                    ["-i", dirs["all"], "-b", "8", "-fmt", "native",
                     "-o", out], 16)
    for kind, blobs in (("dri0", dri0), ("restart", restart)):
        for i in (0, len(blobs) - 1):
            _check_file(f"{out}{kind}_{i}_{size}_nv12.yuv", blobs[i],
                        F.NATIVE, "jpegdecodebatched -fmt native")
    log(f"[cli] jpegdecodebatched -b 8 -fmt native -o, 16 frames (a batch "
        f"of each kind): rc 0, 16 decoded, 0 skipped, 4 files byte-equal to "
        f"numpy; {_rates(res)} (informational)")
    res = _run_tool(jpegdecodeperf.main,
                    ["-i", dirs["threads"], "-t", "2", "-b", "8",
                     "-fmt", "native"], 16)
    log(f"[cli] jpegdecodeperf -t 2 -b 8 -fmt native, 16 frames (a thread "
        f"of each kind): rc 0, 16 decoded; {_rates(res)} (informational)")


def phase_cli_mesh(dirs):
    """jpegdecodeperf --mesh -t 2 -b 8 -fmt native on the 16 frames: each
    thread's MeshDecoder over every card (one here)."""
    from rocjpeg_tpu_torch.tools import jpegdecodeperf
    res = _run_tool(jpegdecodeperf.main,
                    ["-i", dirs["threads"], "-t", "2", "-b", "8",
                     "-fmt", "native", "--mesh"], 16)
    log(f"[cli] jpegdecodeperf --mesh -t 2 -b 8 -fmt native, 16 frames (a "
        f"thread of each kind): rc 0, 16 decoded; {_rates(res)} "
        "(informational)")


# One process of phase_multiprocess: joins a gloo group, decodes its strided
# share of the files with decode_batched_local over make_mesh(), holds each
# image against the oracle's digest and reduces the metrics.
_MULTIPROCESS = r"""
import hashlib, json, sys, time
root, rank, world, address, digests_path, backend, card = sys.argv[1:8]
sys.path.insert(0, root)
rank, world = int(rank), int(world)
import torch.distributed as dist
from rocjpeg_tpu_torch import DecodeParams, OutputFormat, api
from rocjpeg_tpu_torch.dist import mesh, multihost, sharding
multihost.initialize(address, world, rank,
                     backend=None if backend == "default" else backend)
with open(digests_path) as f:
    digests = json.load(f)
mine = multihost.shard_files_for_host(sorted(digests))
streams = []
for path in mine:
    with open(path, "rb") as f:
        streams.append(api.JpegStream(f.read()))
md = sharding.MeshDecoder(mesh.make_mesh(
    devices=None if card == "all" else [rank]))
params = DecodeParams(OutputFormat.NATIVE)
md.decode_batched_local(streams, params)  # warm-up
t0 = time.perf_counter()
per_image, _pitches, err = md.decode_batched_local(streams, params)
sec = time.perf_counter() - t0
md.close()
assert not err.any()
for path, chans in zip(mine, per_image):
    got = hashlib.sha256(b"".join(c.tobytes() for c in chans)).hexdigest()
    assert got == digests[path], path
mpix = sum(s.params.picture_width * s.params.picture_height
           for s in streams) / 1e6
total = multihost.allreduce_metrics(len(mine), mpix, sec)
print(json.dumps({"rank": rank, "backend": dist.get_backend(),
                  "files": len(mine), "sec": sec, "total": total}),
      flush=True)
dist.destroy_process_group()
"""


def _run_processes(world, digests_path, backend):
    """``world`` processes of ``_MULTIPROCESS`` on a free local port, rank
    r on card r (``backend`` None: ``multihost.initialize``'s default) or,
    with gloo, each over every card; returns their JSON results and the
    wall time. Every process is stopped whatever happens."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MULTIPROCESS, ROOT, str(rank), str(world),
         f"127.0.0.1:{port}", digests_path, backend or "default",
         "all" if backend else "rank"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    results = []
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"a decode process exited {p.returncode}:"
                                 f"\n{out}\n{err}")
        results.append(json.loads(out.strip().splitlines()[-1]))
    return results, wall


def phase_multiprocess(torch, dirs, restart, dri0):
    """Two processes on cuda:0 joined by gloo (NCCL cannot put two ranks
    on one card): each decodes its strided half of the 16 files (the
    threads/ names alternate the kinds, so each takes one kind) with
    ``decode_batched_local``, holds every image against the numpy oracle's
    digest, and ``allreduce_metrics`` gives the 16 images, the summed Mpix
    and the longer process's seconds. Both processes are stopped whatever
    happens."""
    import hashlib
    from rocjpeg_tpu_torch import OutputFormat
    fmt = OutputFormat.NATIVE
    kinds = {"dri0": dri0, "restart": restart}
    digests = {}
    for name in sorted(os.listdir(dirs["threads"])):
        i, _k, kind = name[:-len(".jpg")].split("_")
        ref = _numpy_ref(kinds[kind][int(i)], fmt)
        digests[os.path.join(dirs["threads"], name)] = hashlib.sha256(
            b"".join(a.tobytes() for a, _ in ref)).hexdigest()
    digests_path = os.path.join(CLI_DIR, "digests.json")
    with open(digests_path, "w") as f:
        json.dump(digests, f)
    results, wall = _run_processes(2, digests_path, "gloo")
    assert all(r["backend"] == "gloo" for r in results), results
    totals = {tuple(r["total"]) for r in results}
    images, mpix, sec = totals.pop()
    assert not totals and images == 16, results
    assert sec == max(r["sec"] for r in results), results
    assert abs(mpix - 16 * WIDTH * HEIGHT / 1e6) < 1e-6, mpix
    each = ", ".join(f"{r['sec'] * 1e3:.1f}" for r in results)
    log(f"[dist] 2 processes on cuda:0 under gloo, 8 files each "
        f"(decode_batched_local, every image's digest equal to numpy's): "
        f"reduced {int(images)} images, {mpix:.1f} Mpix, {sec * 1e3:.1f} ms "
        f"(the longer process's warm call; each: {each} ms), "
        f"{mpix / sec:.1f} Mpix/s; processes {wall:.1f} s (informational)")


class _CImage(ctypes.Structure):
    _fields_ = [("channel", ctypes.c_void_p * 4),
                ("pitch", ctypes.c_uint32 * 4)]


class _CDecodeParams(ctypes.Structure):
    _fields_ = [("output_format", ctypes.c_int),
                ("crop", ctypes.c_int16 * 4),
                ("target", ctypes.c_uint32 * 2)]


def _c_call(fn, *args):
    st = fn(*args)
    if st != 0:
        raise AssertionError(f"{fn.__name__} returned {st}")


def phase_capi_in_process(torch, capi_dir, blobs):
    """``librocjpeg_tpu_torch.so`` loaded in this process: create a session
    on the card, parse two frames, read their info, and decode them as RGB
    with one rocJpegDecodeBatched into host buffers whose rows are 64
    bytes longer than a row of pixels: the pixels equal numpy's, the
    padding is untouched."""
    import numpy as np
    from rocjpeg_tpu_torch import OutputFormat, capi
    from rocjpeg_tpu_torch.runtime import build as host_build
    if capi.DEVICE_ENV in os.environ:
        raise RuntimeError(f"{capi.DEVICE_ENV} is set: the C ABI would not "
                           "run on the card")
    lib = ctypes.CDLL(os.path.join(capi_dir, host_build.CAPI_LIBRARY))
    vp = ctypes.c_void_p
    lib.rocJpegStreamCreate.argtypes = [ctypes.POINTER(vp)]
    lib.rocJpegStreamParse.argtypes = [ctypes.c_char_p, ctypes.c_size_t, vp]
    lib.rocJpegCreate.argtypes = [ctypes.c_int, ctypes.c_int,
                                  ctypes.POINTER(vp)]
    lib.rocJpegGetImageInfo.argtypes = [vp, vp, vp, vp, vp, vp]
    lib.rocJpegDecodeBatched.argtypes = [vp, vp, ctypes.c_int, vp, vp]
    lib.rocJpegStreamDestroy.argtypes = [vp]
    lib.rocJpegDestroy.argtypes = [vp]
    handle = vp()
    t0 = time.perf_counter()
    _c_call(lib.rocJpegCreate, 0, 0, ctypes.byref(handle))
    t_create = time.perf_counter() - t0
    n = len(blobs)
    streams = (vp * n)()
    for i, blob in enumerate(blobs):
        s = vp()
        _c_call(lib.rocJpegStreamCreate, ctypes.byref(s))
        _c_call(lib.rocJpegStreamParse, blob, len(blob), s)
        streams[i] = s
        nc, css = ctypes.c_uint8(), ctypes.c_int()
        w, h = (ctypes.c_uint32 * 4)(), (ctypes.c_uint32 * 4)()
        _c_call(lib.rocJpegGetImageInfo, handle, s, ctypes.byref(nc),
                ctypes.byref(css), w, h)
        assert (nc.value, css.value, w[0], h[0]) == (3, 3, WIDTH, HEIGHT), (
            nc.value, css.value, w[0], h[0])
    pitch = 3 * WIDTH + 64
    bufs = [np.full((HEIGHT, pitch), SLACK_FILL, np.uint8) for _ in blobs]
    images = (_CImage * n)()
    for img, buf in zip(images, bufs):
        img.channel[0] = buf.ctypes.data
        img.pitch[0] = pitch
    params = _CDecodeParams(output_format=int(OutputFormat.RGB))
    times = []
    for _ in range(3):  # the first call is the warm-up
        t0 = time.perf_counter()
        _c_call(lib.rocJpegDecodeBatched, handle, streams, n,
                ctypes.byref(params), images)
        times.append(time.perf_counter() - t0)
    for i, (blob, buf) in enumerate(zip(blobs, bufs)):
        want = _numpy_ref(blob, OutputFormat.RGB)[0][0]
        if not np.array_equal(buf[:, :3 * WIDTH], want):
            raise AssertionError(f"C ABI RGB image {i} differs from numpy")
        if not (buf[:, 3 * WIDTH:] == SLACK_FILL).all():
            raise AssertionError(f"C ABI RGB image {i}: padding written")
    for s in streams:
        _c_call(lib.rocJpegStreamDestroy, s)
    _c_call(lib.rocJpegDestroy, handle)
    warm = statistics.median(times[1:])
    log(f"[capi] in-process {host_build.CAPI_LIBRARY}: rocJpegCreate "
        f"{t_create * 1e3:.1f} ms; rocJpegDecodeBatched of {n} frames RGB "
        f"into host buffers, pitch row + 64: {times[0] * 1e3:.1f} ms first, "
        f"{warm * 1e3:.1f} ms warm (median of {len(times) - 1}), "
        f"{n * WIDTH * HEIGHT / 1e6 / warm:.1f} Mpix/s; bytes equal to "
        "numpy, padding untouched (informational)")
    return bufs, pitch, warm


def phase_capi_split(blobs, bufs, pitch, warm):
    """Where the C call's time goes: the same frames and buffers through
    the Python API, one step at a time."""
    from rocjpeg_tpu_torch import DecodeParams, OutputFormat, api
    dec = api.Decoder()
    py_streams = [api.JpegStream(b) for b in blobs]
    steps = {"decode_batched + synchronize": [], "channels to the host": [],
             "row copies into the buffers": []}
    for _ in range(3):
        t0 = time.perf_counter()
        imgs = dec.decode_batched(py_streams, DecodeParams(OutputFormat.RGB))
        dec.synchronize()
        t1 = time.perf_counter()
        host = [img.channel[0].cpu().numpy() for img in imgs]
        t2 = time.perf_counter()
        for arr, buf in zip(host, bufs):
            api.write_channel_into(arr, buf.ctypes.data, pitch)
        t3 = time.perf_counter()
        for name, sec in zip(steps, (t1 - t0, t2 - t1, t3 - t2)):
            steps[name].append(sec)
    split = {k: statistics.median(v) for k, v in steps.items()}
    log("[capi] of it, the same steps through the Python API (median of 3): "
        + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in split.items())
        + f"; the C call's remainder {(warm - sum(split.values())) * 1e3:.1f}"
        " ms (informational)")


def phase_capi_samples(capi_dir, dirs, blob):
    """The C samples as processes of their own on the card, the CPU knob
    removed from their environment: jpegdecode_c -fmt rgb -o on one frame
    (its file equal to numpy's bytes), jpegdecodeperf_c -t 2 -b 8 over the
    16 frames (exit 0)."""
    import re
    from rocjpeg_tpu_torch import OutputFormat, capi
    env = dict(os.environ, ROCJPEG_TPU_ROOT=ROOT,
               PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    env.pop(capi.DEVICE_ENV, None)

    def run(name, args):
        t0 = time.perf_counter()
        r = subprocess.run([os.path.join(capi_dir, name), *args], env=env,
                           capture_output=True, text=True, timeout=300)
        sec = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"{name} exited {r.returncode}:\n"
                                 f"{r.stdout}\n{r.stderr}")
        return r.stdout, sec

    out = os.path.join(CLI_DIR, "out", "restart_0_c.rgb")
    stdout, sec = run("jpegdecode_c", [
        "-i", os.path.join(dirs["pair"], "restart_0.jpg"), "-fmt", "rgb",
        "-o", out])
    _check_file(out, blob, OutputFormat.RGB, "jpegdecode_c -fmt rgb")
    ms = float(re.search(r"decoded in ([0-9.]+) ms", stdout).group(1))
    log(f"[capi] jpegdecode_c -fmt rgb -o, 1 frame: exit 0, file byte-equal "
        f"to numpy; rocJpegDecode {ms:.1f} ms (the process's first decode), "
        f"{WIDTH * HEIGHT / 1e3 / ms:.1f} Mpix/s; process "
        f"{sec:.1f} s (informational)")
    stdout, sec = run("jpegdecodeperf_c", ["-i", dirs["threads"], "-t", "2",
                                           "-b", "8"])
    summary = "; ".join(line.removeprefix("info: ") for line in
                        stdout.splitlines()[1:3])
    log(f"[capi] jpegdecodeperf_c -t 2 -b 8, 16 frames (a thread of each "
        f"kind, 4 batches a thread): exit 0; {summary}; process {sec:.1f} s "
        "(informational)")


THROTTLE_LANES = 8  # chunk width of the throttle phase: 32 streams, 4 chunks


def phase_throttle(torch, blobs, depths=(1, 2, 4)):
    """Calls of four chunks (the corpus four times over, chunks of 8)
    without the error check, three at each in-flight depth of 1, 2 and 4:
    the count of reserved slots never passes the depth, synchronize()
    drains it to zero; time and peak memory are printed for a later choice
    of depth."""
    import threading
    from rocjpeg_tpu_torch import (DecodeParams, GpuDecodeSpec, OutputFormat,
                                   api)
    streams = [api.JpegStream(b) for b in blobs] * 4
    params = DecodeParams(OutputFormat.RGB)
    for depth in depths:
        dec = api.Decoder(check_errors=False, spec=GpuDecodeSpec(
            name="throttle", num_decode_lanes=THROTTLE_LANES))
        dec._max_inflight = depth
        dec.decode_batched(streams, params)  # warm-up
        dec.synchronize()
        seen, stop = [], threading.Event()

        def sample():
            while not stop.is_set():
                seen.append(dec._outstanding)
                time.sleep(0.0002)

        sampler = threading.Thread(target=sample, daemon=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sampler.start()
        t_host, t_all = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            imgs = dec.decode_batched(streams, params)
            t_host.append(time.perf_counter() - t0)
            state = (dec._outstanding, len(dec._inflight))
            dec.synchronize()
            t_all.append(time.perf_counter() - t0)
            n_chunks = len(dec.last_paths)
            assert n_chunks == len(streams) // THROTTLE_LANES, dec.last_paths
            assert state == (min(depth, n_chunks),) * 2, state
            assert (dec._outstanding, len(dec._inflight)) == (0, 0)
            del imgs
        stop.set()
        sampler.join(timeout=10)
        assert not sampler.is_alive()
        assert seen and max(seen) <= depth, (depth, max(seen))
        peak = torch.cuda.max_memory_allocated()
        log(f"[throttle] depth {depth}: {len(streams)} streams in "
            f"{n_chunks} chunks, RGB; slots reserved at most {max(seen)}, "
            f"{state} at return, (0, 0) after synchronize(); call returned "
            f"after {statistics.median(t_host) * 1e3:.1f} ms, device done "
            f"after {statistics.median(t_all) * 1e3:.1f} ms (median of 3: "
            f"{', '.join(f'{t * 1e3:.1f}' for t in t_all)}), peak device "
            f"memory {peak / 2 ** 20:.1f} MiB (informational)")


# Profiler ranges of rocjpeg_tpu_torch/pipeline.py and ops/pack.py, in path
# order; rjt.walk runs inside rjt.pack.
STAGES = ("rjt.walk", "rjt.pack", "rjt.upload", "rjt.wave", "rjt.transform",
          "rjt.epilogue")


def _device_kind(name):
    for key, kind in (("wave_kernel", "K1"), ("wave_prologue_kernel", "K1"),
                      ("transform_kernel", "K2"), ("epilogue_kernel", "K3"),
                      ("Memcpy HtoD", "H2D"), ("Memcpy DtoH", "D2H")):
        if key in name:
            return kind
    return "torch"  # PyTorch's own kernels: fills and copies


def _union_us(intervals):
    total, reach = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi > reach:
            total += hi - max(lo, reach)
            reach = hi
    return total


def stage_split(torch, name, fn, trace_dir):
    """One warm call of the decoder under torch.profiler: host time of each
    stage range, device time of each kind of device work, and the device's
    idle share of the call (1 - busy / call, busy being the union of every
    device interval). Returns the names of what ran on the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("rjt.call"):
            fn()
            torch.cuda.synchronize()
    host = dict.fromkeys(STAGES, 0.0)
    device, call = {}, None
    spans, names = [], set()
    for ev in prof.events():
        if ev.name.startswith("rjt."):
            if ev.device_type == DeviceType.CPU:
                if ev.name == "rjt.call":
                    call = (ev.time_range.start, ev.time_range.end)
                elif ev.name in host:
                    host[ev.name] += ev.time_range.elapsed_us()
            continue
        if ev.device_type == DeviceType.CUDA:
            kind = _device_kind(ev.name)
            device[kind] = device.get(kind, 0.0) + ev.time_range.elapsed_us()
            spans.append((ev.time_range.start, ev.time_range.end))
            names.add(ev.name)
    call_us = call[1] - call[0]
    parts = ", ".join(f"{k[4:]} {v / 1e3:.3f}" for k, v in host.items())
    log(f"[stages] {name}: profiled call {call_us / 1e3:.3f} ms; host ms: "
        f"{parts} (walk runs inside pack) (informational)")
    if not spans:
        log(f"[stages] {name}: device time not measured (the profiler "
            "recorded no device events)")
    else:
        busy = _union_us([(max(lo, call[0]), min(hi, call[1]))
                          for lo, hi in spans if hi > call[0]
                          and lo < call[1]])
        parts = ", ".join(f"{k} {v / 1e3:.3f}"
                          for k, v in sorted(device.items()))
        log(f"[stages] {name}: device ms: {parts}; busy {busy / 1e3:.3f} "
            f"ms, idle share {1 - busy / call_us:.4f} (informational)")
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            trace_dir, name.replace(" ", "_") + ".json"))
    return names


def _cuda_ms(torch, fn, runs, calls=1):
    """Median over ``runs`` of the time per call of ``calls`` calls queued
    back to back between two CUDA events. With one call the card waits for
    the host's work before the launch. With ten, the card is first kept
    busy for a few milliseconds (``torch.cuda._sleep``) while the host
    queues all of them behind the start event, so the time is the
    device's even where a wrapper's host work outlasts its kernel."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if calls > 1:
            torch.cuda._sleep(HEAD_START_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def phase_kernel_times(torch, name, plist, virtual_k, errs):
    """K1, K2 and K3 against their plain versions at one main-path group's
    shapes: outputs must be equal (tolerance 0), then each is timed alone
    by CUDA events (the kernels per call of ten queued back to back),
    beside the least time the card could take: the bytes each must move
    (every input read once, every output written once) over the card's
    memory rate. All are bound by bytes: K1 does a few integer operations
    per output byte, K2 about 10, K3 about 7, against some 300 a byte that
    the card can do. K3 is timed for RGB and for NATIVE (NV12, where only
    the UV plane is computed and Y stays a view). Returns
    {kernel: (ms, plain_ms, bound_ms)}, K3's for RGB."""
    from rocjpeg_tpu_torch import OutputFormat, pipeline
    from rocjpeg_tpu_torch.kernels import epilogue, transform, wave
    g = pipeline.pack_group(plist, "cuda", virtual_k=virtual_k)
    dp = g.packed
    wargs = (dp.dense, dp.word_off, dp.img_base, dp.mcu_start, dp.mcu_count,
             dp.lane_bank, g.lentab, g.values, g.geom, dp.n_words,
             g.max_steps)
    coeffs, err = wave.wave_decode(*wargs)
    coeffs_p, err_p = wave.wave_decode_reference(*wargs)
    errs.record("wave", _max_abs(coeffs, coeffs_p))
    errs.record("wave", int((err != err_p).sum().item()))
    targs = (coeffs, g.quant, g.geom, dp.dc_flat, dp.lane_of_mcu)
    for a, b in zip(transform.transform(*targs),
                    transform.transform_reference(*targs)):
        errs.record("transform", _max_abs(a, b))
    planes = transform.transform(*targs)
    for a, b in zip(planes, transform.transform_reference(*targs)):
        errs.record("transform", _max_abs(a, b))
    moved = {
        "wave": _nbytes(dp.dense, dp.word_off, dp.img_base, dp.mcu_start,
                        dp.mcu_count, dp.lane_bank, g.lentab, g.values,
                        coeffs, err),
        "transform": _nbytes(coeffs, g.quant, dp.dc_flat, dp.lane_of_mcu,
                             *planes),
    }
    times = {
        "wave": (_cuda_ms(torch, lambda: wave.wave_decode(*wargs), 5, 10),
                 _cuda_ms(torch, lambda: wave.wave_decode_reference(*wargs),
                          1)),
        "transform": (
            _cuda_ms(torch, lambda: transform.transform(*targs), 5, 10),
            _cuda_ms(torch, lambda: transform.transform_reference(*targs),
                     3)),
    }
    p0 = plist[0]
    for fmt in (OutputFormat.NATIVE, OutputFormat.RGB):
        eargs = (p0.chroma_subsampling, planes, p0.picture_width,
                 p0.picture_height, fmt)
        out = epilogue.render(*eargs)
        for (a, pa), (b, pb) in zip(out, epilogue.render_reference(*eargs)):
            assert pa == pb
            errs.record("epilogue", _max_abs(a, b))
        _mode, plan = epilogue.channel_plan(
            p0.chroma_subsampling, fmt, p0.picture_width, p0.picture_height)
        computed = [a for (a, _), ch in zip(out, plan) if ch.plane is None]
        # NV12 reads U and V and writes UV; RGB reads all three planes.
        read = planes[1:] if fmt == OutputFormat.NATIVE else planes
        kname = "epilogue" if fmt == OutputFormat.RGB else "epilogue NV12"
        moved[kname] = _nbytes(*read, *computed)
        times[kname] = (
            _cuda_ms(torch, lambda: epilogue.render(*eargs), 5, 10),
            _cuda_ms(torch, lambda: epilogue.render_reference(*eargs), 3))
        del out, computed
    for kname, (k, p) in times.items():
        bound = moved[kname] / HBM_BYTES_PER_S * 1e3
        times[kname] = (k, p, bound)
        log(f"[time] {kname} on the {name} group ({dp.word_off.shape[0]} "
            f"lanes, max_steps {g.max_steps}, {g.geom.batch} x "
            f"{WIDTH}x{HEIGHT}): kernel == plain (tolerance 0); kernel "
            f"{k:.4f} ms, plain {p:.3f} ms, bound {bound:.4f} ms "
            f"({moved[kname]} bytes at {HBM_BYTES_PER_S / 1e12} TB/s; the "
            f"kernel is at {bound / k:.3f} of it) (median, informational)")
    return times


def phase_k3_times(torch, errs):
    """K3's other computed layouts, on random planes of the main-path shape
    (their time does not depend on the samples): planar RGB from 4:2:0
    planes and packed YUYV from 4:2:2 planes, and NV12 into pitched caller
    destinations (Y copied and UV computed by the one launch). Equal to the
    plain version first (tolerance 0), then timed as in phase_kernel_times,
    beside the bytes each must move over the card's memory rate."""
    from rocjpeg_tpu_torch import ChromaSubsampling, OutputFormat
    from rocjpeg_tpu_torch.kernels import epilogue
    for label, css, fmt, into in (
            ("epilogue planar RGB", ChromaSubsampling.CSS_420,
             OutputFormat.RGB_PLANAR, False),
            ("epilogue YUYV", ChromaSubsampling.CSS_422, OutputFormat.NATIVE,
             False),
            ("epilogue NV12 into destinations", ChromaSubsampling.CSS_420,
             OutputFormat.NATIVE, True)):
        planes = _random_planes(torch, css, WIDTH, HEIGHT, N_IMAGES, seed=3)
        eargs = (css, planes, WIDTH, HEIGHT, fmt)
        want = epilogue.render_reference(*eargs)
        _mode, plan = epilogue.channel_plan(css, fmt, WIDTH, HEIGHT)
        if into:
            dests = _pitched_dests(torch, want, 64)
            epilogue.render(*eargs, None, dests)
            torch.cuda.synchronize()
            for i in (0, N_IMAGES - 1):
                for ci, (b, _) in enumerate(want):
                    _check_pitched(torch, dests[i], ci, b[i], label)
        else:
            dests = None
            for (a, pa), (b, pb) in zip(epilogue.render(*eargs), want):
                assert pa == pb
                errs.record("epilogue", _max_abs(a, b))
        # Computed channels read the planes they are made from (NV12's UV
        # plane: U and V only); a copied channel is read and written.
        computed = [a for (a, _), ch in zip(want, plan) if ch.plane is None]
        copied = [a for (a, _), ch in zip(want, plan)
                  if ch.plane is not None and into]
        nv12 = (css, fmt) == (ChromaSubsampling.CSS_420, OutputFormat.NATIVE)
        read = planes[1:] if nv12 else planes
        moved = _nbytes(*read, *computed, *copied, *copied)
        del want, computed, copied
        k = _cuda_ms(torch, lambda: epilogue.render(*eargs, None, dests), 5,
                     10)
        p = _cuda_ms(torch, lambda: epilogue.render_reference(*eargs), 3)
        bound = moved / HBM_BYTES_PER_S * 1e3
        log(f"[time] {label} ({N_IMAGES} x {WIDTH}x{HEIGHT}, {css.name[4:]} "
            f"random planes): kernel == plain (tolerance 0); kernel {k:.4f} "
            f"ms, plain {p:.3f} ms, bound {bound:.4f} ms ({moved} bytes at "
            f"{HBM_BYTES_PER_S / 1e12} TB/s; the kernel is at "
            f"{bound / k:.3f} of it) (median, informational)")


# Hostile inputs: the fuzz suite's blobs under each entropy mode and error
# check, then the soak's first batches (clean, mutated and mixed) with the
# error check on and off; each on the card against the port on the CPU.
FUZZ_MODES = (("auto", True), ("on", True), ("on", False))
FUZZ_BATCHES = 8
SOAK_MIN_ITERATIONS = 4
# One group of 1920x1080 4:2:0 frames that mixes restart and DRI=0 streams.
MIXED_FRAME = (1920, 1080)


def _sides(api, entropy, check):
    """The card's decoder and the CPU's, as testing.hostile takes them."""
    from rocjpeg_tpu_torch.status import RocJpegError
    return tuple((api, RocJpegError, api.Decoder(
        device=device, device_entropy=entropy, check_errors=check))
        for device in (None, "cpu"))


def _golden(blob, fmt):
    from rocjpeg_tpu_torch import OutputFormat
    return _numpy_ref(blob, OutputFormat(int(fmt)))


@contextlib.contextmanager
def _one_torch_thread(torch):
    """The CPU decoder's plain K1 steps over small tensors: more intra-op
    threads only spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def phase_fuzz(torch):
    """``[fuzz]``: every blob of the fuzz suite (testing.hostile: truncation
    sweep, 24 bit flips, 6 garbage blobs) through ``Decoder`` on the card
    under ``device_entropy`` "auto" and "on", ``check_errors`` True and
    False, against ``Decoder(device="cpu")`` with the same settings: the
    same status name, or the same failed indices and (where no lane was
    flagged) the same bytes. Then the soak's first batches, with the error
    check on and off under both entropy modes: the same refusals and failed
    indices, clean images equal to the numpy decode, every unflagged image
    equal to the CPU's. Then one group mixing restart and DRI=0 frames of
    one shape (each DRI=0 frame one lane), timed, against numpy. Returns
    the mixed group's streams."""
    import collections
    from rocjpeg_tpu_torch import DecodeParams, OutputFormat, api
    from rocjpeg_tpu_torch.testing import corpus, hostile
    blobs = hostile.fuzz_blobs()
    with _one_torch_thread(torch):
        for entropy, check in FUZZ_MODES:
            card, cpu = _sides(api, entropy, check)
            seen = collections.Counter()
            for kind, blob in blobs:
                got = hostile.outcome(card, blob, OutputFormat.RGB)
                want = hostile.outcome(cpu, blob, OutputFormat.RGB)
                if got != want:
                    raise AssertionError(
                        f"[fuzz] {kind} blob, device_entropy={entropy} "
                        f"check_errors={check}: card {got[:2]}, CPU "
                        f"{want[:2]}")
                seen[got[1] if got[0] == "error" else
                     "decoded, flagged" if got[1] else "decoded"] += 1
            log(f"[fuzz] {len(blobs)} blobs, device_entropy={entropy} "
                f"check_errors={check}: card == CPU decoder "
                f"({dict(seen)})")
        for check in (True, False):
            stats = hostile.new_stats()
            for entropy in hostile.SOAK_ENTROPY:
                card, cpu = _sides(api, entropy, check)
                for i in range(FUZZ_BATCHES):
                    fmt, _, batch = hostile.soak_batch(i)
                    hostile.check_batch(batch, fmt, card, cpu, _golden,
                                        stats)
            stats.pop("configs")
            log(f"[fuzz] soak batches 0-{FUZZ_BATCHES - 1}, auto and on, "
                f"check_errors={check}: card == CPU decoder, clean images "
                f"== numpy ({stats})")
    w, h = MIXED_FRAME
    restart = corpus.build_corpus(2, w, h, seed=5, ri_mcus=4)
    dri0 = corpus.build_corpus(2, w, h, seed=6, ri_mcus=0)
    mixed = [restart[0], dri0[0], restart[1], dri0[1]]
    dec = api.Decoder(device_entropy="on")
    streams = [api.JpegStream(b) for b in mixed]
    fmt = OutputFormat.NATIVE
    dec.decode_batched(streams, DecodeParams(fmt))  # warm-up
    imgs, sec = _decode_timed(torch, dec, streams, DecodeParams(fmt))
    assert [p for p, _ in dec.last_paths] == ["wave"], dec.last_paths
    _check_images(imgs, mixed, fmt, "[fuzz] mixed restart + DRI=0 group")
    log(f"[fuzz] one group of 2 restart + 2 DRI=0 frames {w}x{h} 4:2:0, "
        f"NATIVE: path wave (each DRI=0 frame one lane), byte-equal to "
        f"numpy; warm decode {sec * 1e3:.1f} ms (median of 3, "
        "informational)")
    return streams


def mixed_group_k1_time(torch, streams):
    """K1 alone on the mixed group of ``[fuzz]`` (outside the counted
    phase): CUDA events per call of 3 queued, beside the same frames as two
    groups of their own (restart lanes; virtual lanes)."""
    from rocjpeg_tpu_torch import api, pipeline
    from rocjpeg_tpu_torch.kernels import wave

    def k1(plist, virtual_k=None):
        g = pipeline.pack_group(plist, "cuda", virtual_k=virtual_k)
        dp = g.packed
        args = (dp.dense, dp.word_off, dp.img_base, dp.mcu_start,
                dp.mcu_count, dp.lane_bank, g.lentab, g.values, g.geom,
                dp.n_words, g.max_steps)
        return (_cuda_ms(torch, lambda: wave.wave_decode(*args), 3, 3),
                dp.word_off.shape[0], g.max_steps)

    plist = [s.params for s in streams]
    mixed = k1(plist)
    apart = (k1(plist[0::2]), k1(plist[1::2], api.VIRTUAL_SYMBOLS))
    log(f"[fuzz] K1 on the mixed group: {mixed[0]:.4f} ms ({mixed[1]} "
        f"lanes, max_steps {mixed[2]}); the same frames as two groups: "
        f"restart {apart[0][0]:.4f} ms ({apart[0][1]} lanes), DRI=0 "
        f"{apart[1][0]:.4f} ms ({apart[1][1]} virtual lanes) (median, "
        "informational)")


def phase_soak(torch, budget_s):
    """``[soak]``: the soak of testing.hostile (its fixed sequence of
    seeded batches, alternating "auto" and "on", error check off) on the
    card against ``Decoder(device="cpu")`` for ``budget_s`` seconds after
    its first four iterations, with the CPU tests' floors."""
    from rocjpeg_tpu_torch import api
    from rocjpeg_tpu_torch.testing import hostile
    sides = {e: _sides(api, e, False) for e in hostile.SOAK_ENTROPY}
    t0 = time.perf_counter()
    with _one_torch_thread(torch):
        stats = hostile.run_soak(budget_s, SOAK_MIN_ITERATIONS, sides,
                                 _golden)
    configs = stats.pop("configs")
    assert stats["clean"] == stats["clean_exact"] >= 5, stats
    assert stats["mutated"] >= 5 and len(configs) >= 4, stats
    assert stats["mixed_batches"] >= 1 and stats["failed_images"] >= 1, stats
    log(f"[soak] {stats['iterations']} iterations in "
        f"{time.perf_counter() - t0:.1f} s (budget {budget_s} s): card == "
        f"CPU decoder, clean images == numpy; {stats}, {len(configs)} "
        "configurations")


# Frames past 4K: 8K UHD and a 61-Mpix camera frame, 4:2:0. Restart frames
# are stacked from one encoded strip of 16 rows (testing.corpus.strip_frame,
# the restart interval dividing the MCUs of a row); the DRI=0 frame is
# encoded whole.
LARGE_8K = (7680, 4320, 4)
LARGE_61MP = (9504, 6336, 3)
LARGE_COPIES = 32
# K1 forms a coefficient's index in 32 bits: the most coefficients a chunk
# may hold.
K1_MAX_COEFFS = 2 ** 31 - 1


def _expected_chunks(n, lanes, per_image):
    """Chunk sizes of ``n`` same-shape images: at most ``lanes`` images and
    ``K1_MAX_COEFFS`` coefficients a chunk (32 x 8K: [32]; 32 x 61 Mpix:
    [23, 9])."""
    width = min(lanes, K1_MAX_COEFFS // per_image)
    return [width] * (n // width) + ([n % width] if n % width else [])


def _check_strip_frame(img, frame_h, strip, fmt, what):
    """Every band of a stacked frame's decode equals the numpy decode of its
    strip (checked on the card)."""
    import torch
    for ci, (band, pitch) in enumerate(_numpy_ref(strip, fmt)):
        if img.pitch[ci] != pitch:
            raise AssertionError(f"{what}: channel {ci} pitch")
        got = img.channel[ci]
        rows = band.shape[0]
        want = torch.from_numpy(band).to(got.device)
        if got.shape[0] * 16 != rows * frame_h or not torch.equal(
                got.reshape(-1, *want.shape),
                want.expand(got.shape[0] // rows, *want.shape)):
            raise AssertionError(f"{what}: channel {ci} differs from the "
                                 "numpy decode of its strip")


def _copies_equal(torch, imgs, one):
    return sum(all(torch.equal(a, b) for a, b in zip(img.channel, one.channel)
                   if b is not None) for img in imgs)


def _large_call(torch, dec, streams, fmt):
    from rocjpeg_tpu_torch import DecodeParams
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    imgs = dec.decode_batched(streams, DecodeParams(fmt))
    torch.cuda.synchronize()
    return (imgs, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2 ** 20)


def phase_large(torch):
    """``[large]``: a 7680x4320 restart frame and a DRI=0 one, each alone
    through ``decode_batched`` as NATIVE and RGB against numpy, then each
    repeated 32 times in one call (one chunk of 32 at the card's width,
    1.59e9 coefficients), every copy equal to the single decode; then a
    9504x6336 restart frame repeated 32 times, which must split 23 + 9
    (2.89e9 coefficients would pass K1's 32-bit addressing), every copy
    equal to its single decode. Times and peak device memory of each call
    are printed."""
    from rocjpeg_tpu_torch import OutputFormat, api
    from rocjpeg_tpu_torch.ops.tables import GroupGeometry
    from rocjpeg_tpu_torch.testing import corpus
    t0 = time.perf_counter()
    w8, h8, ri8 = LARGE_8K
    w61, h61, ri61 = LARGE_61MP
    # name: (frame, its strip or None, height)
    frames = {
        "8K restart": (*corpus.strip_frame(w8, h8, ri8, seed=7), h8),
        "8K DRI=0": (corpus.build_corpus(1, w8, h8, seed=9, ri_mcus=0)[0],
                     None, h8),
        "61-Mpix restart": (*corpus.strip_frame(w61, h61, ri61, seed=8), h61),
    }
    log(f"[large] frames ready in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {len(v[0])} B' for k, v in frames.items())})")
    dec = api.Decoder()
    lanes = dec.spec.num_decode_lanes
    assert lanes == LARGE_COPIES, dec.spec
    for name, (frame, strip, fh) in frames.items():
        stream = api.JpegStream(frame)
        fmts = ((OutputFormat.NATIVE, OutputFormat.RGB)
                if name.startswith("8K") else (OutputFormat.NATIVE,))
        singles = {}
        for fmt in fmts:
            (one,), sec, peak = _large_call(torch, dec, [stream], fmt)
            singles[fmt] = one
            path = dec.last_paths[0][0]
            if strip is None:
                _check_images([one], [frame], fmt, f"[large] {name}")
            else:
                _check_strip_frame(one, fh, strip, fmt, f"[large] {name}")
            log(f"[large] {name} {fmt.name}: path {path}, byte-equal to "
                f"numpy{' (every band to its strip)' if strip else ''}; "
                f"{sec * 1e3:.1f} ms, peak device memory {peak:.1f} MiB "
                "(cold call, informational)")
        fmt = OutputFormat.NATIVE
        imgs, sec, peak = _large_call(torch, dec, [stream] * LARGE_COPIES,
                                      fmt)
        chunks = [(p, len(i)) for p, i in dec.last_paths]
        per_image = GroupGeometry.from_params(stream.params, 1).total_blocks
        per_image *= 64
        equal = _copies_equal(torch, imgs, singles[fmt])
        want_chunks = _expected_chunks(LARGE_COPIES, lanes, per_image)
        log(f"[large] {name} x {LARGE_COPIES} in one call, {fmt.name}: "
            f"last_paths {chunks} at {lanes} lanes ({per_image} "
            f"coefficients a frame, {per_image * max(n for _, n in chunks)} "
            f"in the largest chunk), {equal} of {LARGE_COPIES} copies "
            f"byte-equal to the single decode; {sec * 1e3:.1f} ms, peak "
            f"device memory {peak:.1f} MiB (informational)")
        if [n for _, n in chunks] != want_chunks or equal != LARGE_COPIES:
            raise AssertionError(f"[large] {name}: chunks {chunks}, want "
                                 f"{want_chunks}; {equal} copies equal")
        del imgs, one, singles


def multi_card(torch):
    """``--multi-card``: the kernels and the host library built, the first
    4 frames of each corpus encoded, then :func:`phase_multi_card`."""
    from rocjpeg_tpu_torch.kernels import build
    from rocjpeg_tpu_torch.runtime import build as host_build
    from rocjpeg_tpu_torch.testing import corpus
    host_build.build()
    build.library()
    t0 = time.perf_counter()
    restart = corpus.build_corpus(4, WIDTH, HEIGHT, ri_mcus=4)
    dri0 = corpus.build_corpus(4, WIDTH, HEIGHT, seed=1, ri_mcus=0)
    log(f"[corpus] 2 x 4 frames {WIDTH}x{HEIGHT} 4:2:0, ready in "
        f"{time.perf_counter() - t0:.1f} s")
    phase_multi_card(torch, restart, dri0)
    check_no_foreign_modules()


def main():
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace-dir", default=None,
                    help="write each profiled main-path call's Chrome trace "
                         "here")
    ap.add_argument("--multi-card", action="store_true",
                    help="run only the multi-card phase, over every card of "
                         "the machine (two or more)")
    ap.add_argument("--only", choices=("fuzz", "soak", "large"),
                    help="build, then run only this phase (fuzz: after the "
                         "K1 checks)")
    ap.add_argument("--soak-secs", type=float, default=45.0,
                    help="time budget of the [soak] phase (default 45)")
    args = ap.parse_args()
    card = phase_environment(torch)

    def done():
        log(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)

    if args.multi_card:
        multi_card(torch)
        done()
        return
    forced, capi_dir = phase_build()
    errs = Errors()
    from rocjpeg_tpu_torch.kernels import build, epilogue, transform, wave
    if args.only in (None, "fuzz"):
        for flush, lib in ((None, None), *forced.items()):
            build.use(lib)
            log("[K1] flush " + ("by the lane count" if flush is None
                                 else f"{flush} forced") + ":")
            phase_k1_checks(torch, errs)
        build.use(None)

    # The counts are zeroed just before each counted phase and read just
    # after; every kernel must have been launched in each.
    modules = {"wave": wave, "transform": transform, "epilogue": epilogue}
    launches = dict.fromkeys(modules, 0)
    by_phase = {}

    def counted(name, fn, *fn_args):
        for mod in modules.values():
            mod.launches = 0
        result = fn(*fn_args)
        for kname, mod in modules.items():
            if mod.launches == 0:
                raise AssertionError(
                    f"the {name} path never launched the {kname} kernel")
            launches[kname] += mod.launches
        by_phase[name] = [mod.launches for mod in modules.values()]
        return result

    # Hostile and very large inputs, in this order after the main path's
    # other phases, or one of them alone.
    hostile_and_large = {
        "fuzz": lambda: mixed_group_k1_time(
            torch, counted("fuzz", phase_fuzz, torch)),
        "soak": lambda: counted("soak", phase_soak, torch, args.soak_secs),
        "large": lambda: counted("large", phase_large, torch)}
    if args.only:
        hostile_and_large[args.only]()
        check_no_foreign_modules()
        log(f"[main] kernel launches (K1, K2, K3) by counted phase: "
            f"{by_phase}")
        done()
        return
    phase_k2_checks(torch, errs)
    phase_k3_checks(torch, errs)
    phase_k3_alignment(torch)

    from rocjpeg_tpu_torch import OutputFormat, api
    from rocjpeg_tpu_torch.core.bitstream import JpegStreamParser
    from rocjpeg_tpu_torch.testing import corpus
    t0 = time.perf_counter()
    restart = corpus.build_corpus(N_IMAGES, WIDTH, HEIGHT, ri_mcus=4)
    dri0 = corpus.build_corpus(N_IMAGES, WIDTH, HEIGHT, seed=1, ri_mcus=0)
    odd = [(corpus.build_corpus(1, *ODD_FRAME, seed=2, ri_mcus=ri)[0], label,
            path) for ri, label, path in (
                (4, "restart", "wave"), (0, "dri0", "wave-virtual"))]
    log(f"[corpus] 2 x {N_IMAGES} frames {WIDTH}x{HEIGHT} and 2 frames "
        f"{ODD_FRAME[0]}x{ODD_FRAME[1]}, 4:2:0, ready in "
        f"{time.perf_counter() - t0:.1f} s")

    # The main path: decode_batched on both corpora, then decode_into on
    # both, then every other entry point and the hostile and large inputs.
    peak, on_device = 0, {}
    for name, blobs, fmts, want_path in (
            ("restart", restart, (OutputFormat.NATIVE, OutputFormat.RGB),
             "wave"),
            ("dri0", dri0, (OutputFormat.NATIVE,), "wave-virtual")):
        cell_peak, on_device[name] = counted(
            name, phase_main_path, torch, name, blobs, fmts, want_path,
            args.trace_dir)
        peak = max(peak, cell_peak)
    corpora = (("restart", restart, "wave"), ("dri0", dri0, "wave-virtual"))
    for name, blobs, want_path in corpora:
        counted(f"{name} decode_into", phase_decode_into, torch, name, blobs,
                want_path, on_device[name])
    counted("dist", phase_dist, torch, corpora, args.trace_dir)
    counted("spec", phase_spec, torch, restart)
    # The user-facing entry points: the CLIs and the C ABI in this process
    # must launch every kernel too.
    dirs = _write_cli_corpus(restart, dri0)
    counted("cli", phase_cli, dirs, restart, dri0)
    # The C ABI's launches are counted alone; its Python-API split after it
    # is a phase of its own.
    pair = [restart[0], restart[-1]]
    split_args = counted("capi", phase_capi_in_process, torch, capi_dir, pair)
    counted("capi split", phase_capi_split, pair, *split_args)
    phase_capi_samples(capi_dir, dirs, restart[0])
    counted("cli --mesh", phase_cli_mesh, dirs)
    phase_multiprocess(torch, dirs, restart, dri0)
    shutil.rmtree(CLI_DIR)  # some 400 MB of frames and decoded files
    for phase in hostile_and_large.values():
        phase()
    check_no_foreign_modules()
    log(f"[main] kernel launches (K1, K2, K3) by counted phase: {by_phase}")
    log(f"[main] kernel launches on the main path: {launches}; peak device "
        f"memory of the decode_batched calls {peak / 2 ** 20:.1f} MiB "
        "(informational)")

    for blob, label, want_path in odd:
        phase_odd_frame(torch, blob, f"{ODD_FRAME[0]}x{ODD_FRAME[1]} {label}",
                        want_path)
    phase_throttle(torch, restart)

    times = phase_kernel_times(
        torch, "restart", [JpegStreamParser().parse(b) for b in restart],
        None, errs)
    phase_kernel_times(torch, "dri0",
                       [JpegStreamParser().parse(b) for b in dri0],
                       api.VIRTUAL_SYMBOLS, errs)
    phase_k3_times(torch, errs)
    # The times of the restart group (K3's for RGB); the DRI=0 group's and
    # K3's for NV12 are in the [time] lines above. No single PyTorch call
    # computes a Huffman decode, this fixed-point IDCT, or this upsample +
    # fixed-point colour conversion + interleave, so no kernel has a
    # library yardstick.
    sources = {"wave": ("rocjpeg_tpu_torch/csrc/wave.cu",
                        "rocjpeg_tpu/kernels/wave_pallas.py:86"),
               "transform": ("rocjpeg_tpu_torch/csrc/transform.cu",
                             "rocjpeg_tpu/pipeline.py:194"),
               "epilogue": ("rocjpeg_tpu_torch/csrc/epilogue.cu",
                            "rocjpeg_tpu/ops/postprocess.py:55")}
    log(json.dumps({"kernels": [
        {"name": kname, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[kname], "max_abs_err": errs.max_abs[kname],
         "ms": times[kname][0], "plain_ms": times[kname][1],
         "bound_ms": times[kname][2], "bound_by": "bytes",
         "library_ms": None}
        for kname, (src, replaces) in sources.items()]}))
    done()


if __name__ == "__main__":
    main()
