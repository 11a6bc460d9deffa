#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--trace-dir DIR]

Builds the port's native host library with g++ and its CUDA kernels (K1
wave entropy decode, K2 transform) with nvcc from this checkout, holds each
kernel against its plain PyTorch version on the card (K1 once as the
package launches it and once with each of its two flushes forced, so that
both meet every hazard case at a small size), then drives the main
path — ``rocjpeg_tpu_torch.api.Decoder().decode_batched`` — over 8 frames
of 3840x2160 4:2:0, once with restart markers (real restart lanes, NATIVE
then RGB) and once without (DRI=0, virtual-restart lanes), and checks two
images of each byte for byte against an independent numpy decode
(``rocjpeg_tpu_torch.testing.numpy_decode``). One more warm call per format
runs under torch.profiler and splits its time by the pipeline's stage
ranges (host) and by kind of device work, with the device's idle share.
Each kernel is then timed alone, by CUDA events around ten calls queued
back to back, at both groups' shapes, beside the least time the card could
take for the same bytes. Every phase
succeeds or raises; the script catches nothing. It imports nothing of jax
or of the JAX package. Timings printed are informational, not gates.

Needs one CUDA device; exits non-zero without one. Synthesized corpora are
cached under build/rjt_bench_corpus (override with BENCH_CORPUS_CACHE).
The last stdout line is the JSON result.
"""

import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_IMAGES = 8
WIDTH, HEIGHT = 3840, 2160
HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet
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


def phase_build():
    from rocjpeg_tpu_torch.kernels import build
    from rocjpeg_tpu_torch.runtime import build as host_build
    t0 = time.perf_counter()
    path = host_build.build()
    log(f"[build] host library g++: {time.perf_counter() - t0:.1f} s "
        f"({path})")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:  # one nvcc each
        forced = {f: pool.submit(build.load, (f"RJT_WAVE_FLUSH={f}",))
                  for f in K1_FLUSHES}
        build.library()
        forced = {f: fut.result() for f, fut in forced.items()}
    log(f"[build] K1+K2 nvcc sm_90a, and K1 with each flush forced: "
        f"{time.perf_counter() - t0:.1f} s ({build.library_path()})")
    with open(build.library_path() + ".ptxas.txt") as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            used = next((x.split(":", 1)[1].strip() for x in lines[i + 1:i + 4]
                         if "Used" in x), "?")
            log(f"[build] ptxas {name}: {used}")
    foreign = sorted(m for m in sys.modules if m in ("jax", "rocjpeg_tpu")
                     or m.startswith(("jax.", "jaxlib", "rocjpeg_tpu.")))
    if foreign:
        raise RuntimeError(f"the port imported {foreign}")
    return forced


def _max_abs(a, b):
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


class Errors:
    """Largest kernel-vs-plain difference seen per kernel."""

    def __init__(self):
        self.max_abs = {"wave": 0, "transform": 0}

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
    from rocjpeg_tpu_torch.testing import numpy_decode
    dec = api.Decoder()
    streams = [api.JpegStream(b) for b in blobs]
    mpix = len(blobs) * WIDTH * HEIGHT / 1e6
    for fmt in fmts:
        dec.decode_batched(streams, DecodeParams(fmt))  # warm-up
        imgs, sec = _decode_timed(torch, dec, streams, DecodeParams(fmt))
        paths = [p for p, _ in dec.last_paths]
        assert paths and all(p == want_path for p in paths), paths
        for i in (0, len(blobs) - 1):
            ref = numpy_decode.decode(blobs[i], fmt)
            for ci, (arr, _pitch) in enumerate(ref):
                got = imgs[i].channel[ci].cpu().numpy()
                if not np.array_equal(got, arr):
                    raise AssertionError(
                        f"{name} {fmt.name}: image {i} channel {ci} differs "
                        "from the numpy reference")
        log(f"[main] {name} {fmt.name}: paths {sorted(set(paths))}, 2 images "
            f"byte-equal to numpy; warm decode {sec * 1e3:.1f} ms, "
            f"{mpix / sec:.1f} Mpix/s (informational)")
        stage_split(torch, f"{name} {fmt.name}", dec, streams,
                    DecodeParams(fmt), trace_dir)


# Profiler ranges of rocjpeg_tpu_torch/pipeline.py and ops/pack.py, in path
# order; rjt.walk runs inside rjt.pack.
STAGES = ("rjt.walk", "rjt.pack", "rjt.upload", "rjt.wave", "rjt.transform",
          "rjt.epilogue")


def _device_kind(name):
    for key, kind in (("wave_kernel", "K1"), ("wave_prologue_kernel", "K1"),
                      ("transform_kernel", "K2"),
                      ("Memcpy HtoD", "H2D"), ("Memcpy DtoH", "D2H")):
        if key in name:
            return kind
    return "torch"  # the epilogue's kernels, other fills and copies


def _union_us(intervals):
    total, reach = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi > reach:
            total += hi - max(lo, reach)
            reach = hi
    return total


def stage_split(torch, name, dec, streams, params, trace_dir):
    """One warm decode_batched call under torch.profiler: host time of each
    stage range, device time of each kind of device work, and the device's
    idle share of the call (1 - busy / call, busy being the union of every
    device interval)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("rjt.call"):
            dec.decode_batched(streams, params)
            torch.cuda.synchronize()
    host = dict.fromkeys(STAGES, 0.0)
    device, call = {}, None
    spans = []
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


def _cuda_ms(torch, fn, runs, calls=1):
    """Median over ``runs`` of the time per call of ``calls`` calls queued
    back to back between two CUDA events. With one call the card waits for
    the host's work before the launch; with ten the host runs ahead and
    the time is the device's."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
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
    """K1 and K2 against their plain versions at one main-path group's
    shapes: outputs must be equal (tolerance 0), then both are timed alone
    by CUDA events (the kernels per call of ten queued back to back), beside the least time the card could take: the bytes
    each must move (every input read once, every output written once) over
    the card's memory rate. Both are bound by bytes: K1 does a few integer
    operations per output byte, K2 about 10, against some 300 a byte that
    the card can do. Returns {kernel: (ms, plain_ms, bound_ms)}."""
    from rocjpeg_tpu_torch import pipeline
    from rocjpeg_tpu_torch.kernels import transform, wave
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


def main():
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace-dir", default=None,
                    help="write each profiled main-path call's Chrome trace "
                         "here")
    args = ap.parse_args()
    card = phase_environment(torch)
    forced = phase_build()
    errs = Errors()
    from rocjpeg_tpu_torch.kernels import build
    for flush, lib in ((None, None), *forced.items()):
        build.use(lib)
        log("[K1] flush " + ("by the lane count" if flush is None
                             else f"{flush} forced") + ":")
        phase_k1_checks(torch, errs)
    build.use(None)
    phase_k2_checks(torch, errs)

    from rocjpeg_tpu_torch import OutputFormat, api
    from rocjpeg_tpu_torch.core.bitstream import JpegStreamParser
    from rocjpeg_tpu_torch.kernels import transform, wave
    from rocjpeg_tpu_torch.testing import corpus
    t0 = time.perf_counter()
    restart = corpus.build_corpus(N_IMAGES, WIDTH, HEIGHT, ri_mcus=4)
    dri0 = corpus.build_corpus(N_IMAGES, WIDTH, HEIGHT, seed=1, ri_mcus=0)
    log(f"[corpus] 2 x {N_IMAGES} frames {WIDTH}x{HEIGHT} 4:2:0 ready in "
        f"{time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    launches = {"wave": 0, "transform": 0}
    for name, blobs, fmts, want_path in (
            ("restart", restart, (OutputFormat.NATIVE, OutputFormat.RGB),
             "wave"),
            ("dri0", dri0, (OutputFormat.NATIVE,), "wave-virtual")):
        wave.launches = 0
        transform.launches = 0
        phase_main_path(torch, name, blobs, fmts, want_path, args.trace_dir)
        for kname, n in (("wave", wave.launches),
                         ("transform", transform.launches)):
            if n == 0:
                raise AssertionError(
                    f"the {name} path never launched the {kname} kernel")
            launches[kname] += n
    peak = torch.cuda.max_memory_allocated()
    log(f"[main] kernel launches on the main path: {launches}; peak device "
        f"memory {peak / 2 ** 20:.1f} MiB (informational)")

    times = phase_kernel_times(
        torch, "restart", [JpegStreamParser().parse(b) for b in restart],
        None, errs)
    phase_kernel_times(torch, "dri0",
                       [JpegStreamParser().parse(b) for b in dri0],
                       api.VIRTUAL_SYMBOLS, errs)
    log(card)
    # The times of the restart group; the DRI=0 group's are in the [time]
    # lines above. No PyTorch call computes a Huffman decode or this fixed-
    # point IDCT, so neither kernel has a library yardstick.
    sources = {"wave": ("rocjpeg_tpu_torch/csrc/wave.cu",
                        "rocjpeg_tpu/kernels/wave_pallas.py:86"),
               "transform": ("rocjpeg_tpu_torch/csrc/transform.cu",
                             "rocjpeg_tpu/pipeline.py:194")}
    log(json.dumps({"kernels": [
        {"name": kname, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[kname], "max_abs_err": errs.max_abs[kname],
         "ms": times[kname][0], "plain_ms": times[kname][1],
         "bound_ms": times[kname][2], "bound_by": "bytes",
         "library_ms": None}
        for kname, (src, replaces) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
