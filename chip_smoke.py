#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--trace-dir DIR]

Builds the port's CUDA kernels (K1 wave entropy decode, K2 transform) with
nvcc from this checkout, holds each against its plain PyTorch version on
the card, then drives the main path — ``rocjpeg_tpu_torch.api.Decoder
().decode_batched`` — over 8 frames of 3840x2160 4:2:0, once with restart
markers (real restart lanes, NATIVE then RGB) and once without (DRI=0,
virtual-restart lanes), and checks two images of each byte for byte
against an independent numpy decode. One more warm call per format runs
under torch.profiler and splits its time by the pipeline's stage ranges
(host) and by kind of device work, with the device's idle share. Every
phase succeeds or raises; the script catches nothing. Timings printed are
informational, not gates.

Needs one CUDA device; exits non-zero without one. Synthesized corpora are
cached under build/rjt_bench_corpus (override with BENCH_CORPUS_CACHE).
The last stdout line is the JSON result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_IMAGES = 8
WIDTH, HEIGHT = 3840, 2160


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
    lib = os.path.join(ROOT, "rocjpeg_tpu", "runtime", "librocjpeg_host.so")
    if not os.path.exists(lib):
        subprocess.run([sys.executable, os.path.join(ROOT, "csrc", "build.py")],
                       check=True)
    import rocjpeg_tpu_torch  # noqa: F401  (loads rocjpeg_tpu without jax)
    from rocjpeg_tpu.runtime import native
    if not native.INDEX_AVAILABLE:
        raise RuntimeError("native host library lacks the index walk")
    if "jax" in sys.modules:
        raise RuntimeError("the port imported jax")
    return card


def phase_build():
    from rocjpeg_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    log(f"[build] K1+K2 nvcc sm_90a: {time.perf_counter() - t0:.1f} s "
        f"({build.library_path()})")


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


def _wave_case(torch, plist, virtual_k=None, flags_only=False, errs=None):
    from rocjpeg_tpu_torch import pipeline
    from rocjpeg_tpu_torch.kernels import wave
    g = pipeline.pack_group(plist, "cuda", virtual_k=virtual_k)
    dp = g.packed
    args = (dp.dense, dp.word_off, dp.img_base, dp.mcu_start, dp.mcu_count,
            dp.lane_bank, g.lentab, g.values, g.geom, dp.n_words,
            g.max_steps)
    out_k, err_k = wave.wave_decode(*args)
    out_p, err_p = wave.wave_decode_reference(*args)
    torch.cuda.synchronize()
    errs.record("wave", int((err_k != err_p).sum().item()))
    if not flags_only:
        errs.record("wave", _max_abs(out_k, out_p))
    return g, out_k, err_k


def phase_kernel_checks(torch, errs):
    import numpy as np
    from rocjpeg_tpu.core.bitstream import JpegStreamParser
    from rocjpeg_tpu.testing import encoder
    from rocjpeg_tpu_torch.kernels import transform

    def streams(css, ri, variants=(0, 0), w=128, h=96):
        return [JpegStreamParser().parse(encoder.encode_planes(
            encoder.random_planes(css, w, h, seed=s), css,
            restart_interval=ri, table_variant=v))
            for s, v in enumerate(variants)]

    for css in ("420", "444"):
        _wave_case(torch, streams(css, 1), errs=errs)
        log(f"[K1] restart lanes {css}: kernel == plain (tolerance 0)")
    _wave_case(torch, streams("420", 0), virtual_k=100, errs=errs)
    log("[K1] virtual lanes 420: kernel == plain")
    g, _, _ = _wave_case(torch, streams("420", 2, variants=(0, 1)), errs=errs)
    assert g.lentab.shape[0] == 8, "expected a 2-bank group"
    log("[K1] 2-bank group: kernel == plain")
    # One lane per image (DRI=0 packed as a single restart segment); 24
    # stuffed 0xFF bytes mid-scan: a run of one-bits no Huffman code has.
    bad = streams("420", 0)[:1]
    data = bytearray(bad[0].slice_data)
    data[16:64] = b"\xff\x00" * 24
    bad[0].slice_data = bytes(data)
    _, _, err_k = _wave_case(torch, bad, flags_only=True, errs=errs)
    assert bool(err_k.any()), "corrupt scan raised no error flag"
    log("[K1] corrupt scan: error flags == plain")

    # K2 on extreme coefficients: int32 and int16 wraparound.
    g = _wave_case(torch, streams("420", 0), virtual_k=50, errs=errs)[0]
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


def numpy_reference(blob, fmt):
    """Independent decode: native C++ entropy decode, numpy IDCT and
    numpy epilogue (all of rocjpeg_tpu's jax-free host layer)."""
    import numpy as np
    from rocjpeg_tpu.core.bitstream import JpegStreamParser
    from rocjpeg_tpu.core.zigzag import dezigzag
    from rocjpeg_tpu.ops import idct, layout, postprocess
    from rocjpeg_tpu.runtime import host_decode
    p = JpegStreamParser().parse(blob)
    planes = []
    for ci, c in enumerate(host_decode.decode_coefficients(p)):
        qid = p.components[ci].quantiser_table_selector
        q = dezigzag(p.quantiser_tables[qid].astype(np.int32)).reshape(8, 8)
        blocks = c.reshape(c.shape[:2] + (8, 8))
        planes.append(layout.blocks_to_plane(
            np, idct.dequant_idct_8x8(np, blocks, q)))
    return postprocess.render_output(np, p.chroma_subsampling, tuple(planes),
                                     p.picture_width, p.picture_height, fmt)


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
    for fmt in fmts:
        dec.decode_batched(streams, DecodeParams(fmt))  # warm-up
        imgs, sec = _decode_timed(torch, dec, streams, DecodeParams(fmt))
        paths = [p for p, _ in dec.last_paths]
        assert paths and all(p == want_path for p in paths), paths
        for i in (0, len(blobs) - 1):
            ref = numpy_reference(blobs[i], fmt)
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
    for key, kind in (("wave_kernel", "K1"), ("transform_kernel", "K2"),
                      ("Memcpy HtoD", "H2D"), ("Memcpy DtoH", "D2H")):
        if key in name:
            return kind
    return "torch"  # the epilogue's kernels, zero fills, other copies


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


def _cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernel_times(torch, name, plist, virtual_k, errs):
    """K1 and K2 against their plain versions at one main-path group's
    shapes: outputs must be equal (tolerance 0), then both are timed."""
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
    times = {
        "wave": (_cuda_ms(torch, lambda: wave.wave_decode(*wargs), 5),
                 _cuda_ms(torch, lambda: wave.wave_decode_reference(*wargs),
                          1)),
        "transform": (
            _cuda_ms(torch, lambda: transform.transform(*targs), 10),
            _cuda_ms(torch, lambda: transform.transform_reference(*targs),
                     3)),
    }
    for kname, (k, p) in times.items():
        log(f"[time] {kname} on the {name} group ({dp.word_off.shape[0]} "
            f"lanes, max_steps {g.max_steps}, {g.geom.batch} x "
            f"{WIDTH}x{HEIGHT}): kernel == plain (tolerance 0); kernel "
            f"{k:.3f} ms, plain {p:.3f} ms (median, informational)")
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
    phase_build()
    errs = Errors()
    phase_kernel_checks(torch, errs)

    os.environ.setdefault("BENCH_CORPUS_CACHE",
                          os.path.join(ROOT, "build", "rjt_bench_corpus"))
    import bench  # after rocjpeg_tpu_torch: bench's encoder import finds
    #               rocjpeg_tpu loaded without jax
    from rocjpeg_tpu.core.bitstream import JpegStreamParser
    from rocjpeg_tpu.types import OutputFormat
    from rocjpeg_tpu_torch import api
    from rocjpeg_tpu_torch.kernels import transform, wave
    t0 = time.perf_counter()
    restart = bench.build_corpus(N_IMAGES, WIDTH, HEIGHT, ri_mcus=4)
    dri0 = bench.build_corpus(N_IMAGES, WIDTH, HEIGHT, seed=1, ri_mcus=0)
    log(f"[corpus] 2 x {N_IMAGES} frames {WIDTH}x{HEIGHT} 4:2:0 ready in "
        f"{time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    wave.launches = 0
    transform.launches = 0
    phase_main_path(torch, "restart", restart,
                    (OutputFormat.NATIVE, OutputFormat.RGB), "wave",
                    args.trace_dir)
    phase_main_path(torch, "dri0", dri0, (OutputFormat.NATIVE,),
                    "wave-virtual", args.trace_dir)
    launches = {"wave": wave.launches, "transform": transform.launches}
    peak = torch.cuda.max_memory_allocated()
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"main path never launched the {name} kernel")
    log(f"[main] kernel launches on the main path: {launches}; peak device "
        f"memory {peak / 2 ** 20:.1f} MiB (informational)")

    times = phase_kernel_times(
        torch, "restart", [JpegStreamParser().parse(b) for b in restart],
        None, errs)
    phase_kernel_times(torch, "dri0",
                       [JpegStreamParser().parse(b) for b in dri0],
                       api.VIRTUAL_SYMBOLS, errs)
    log(card)
    log(json.dumps({"kernels": [
        {"name": "wave", "route": "cuda",
         "source": "rocjpeg_tpu_torch/csrc/wave.cu",
         "replaces": "rocjpeg_tpu/kernels/wave_pallas.py:86",
         "launches": launches["wave"], "max_abs_err": errs.max_abs["wave"],
         "ms": times["wave"][0], "plain_ms": times["wave"][1]},
        {"name": "transform", "route": "cuda",
         "source": "rocjpeg_tpu_torch/csrc/transform.cu",
         "replaces": "rocjpeg_tpu/pipeline.py:194",
         "launches": launches["transform"],
         "max_abs_err": errs.max_abs["transform"],
         "ms": times["transform"][0], "plain_ms": times["transform"][1]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
