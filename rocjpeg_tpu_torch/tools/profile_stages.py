"""Stage roofline of the port's main path, the counterpart of the root
``tools/profile_stages.py``.

    python -m rocjpeg_tpu_torch.tools.profile_stages [-d N|cpu]

Two legs, each in a process of its own (``PROF_LEG``): ``headline``, the
bench's frames with a restart marker every ``BENCH_RI_MCUS`` MCUs (real
restart lanes), and ``mug``, 32 copies of the bench's mug image
(``bench.MUG_PATH``, DRI=0: the host index walk and virtual lanes), as in
the root tool, or, where that file is absent, ``dri0``, the bench's frames
without restart markers, standing in for it. They are the bench's corpora
(``tools/bench.py`` ``leg_corpus``; ``BENCH_BATCH`` frames of ``BENCH_W`` x
``BENCH_H`` but for mug), NATIVE. Each stage is timed warm, as the main path runs it,
with every fill and allocation the main path makes for it; its figure is
the median of ``PROF_REPS`` reps (default 3):

- ``parse``: ``api.JpegStream`` of every frame (host);
- ``walk`` (mug, dri0): ``ops.pack.index_walk``, the native index walk on the
  pooled buffer sets of ``staging.walk_buffer_pool()`` (host), with the
  chunks each walker took in one more call (``walkers``,
  ``ops.pack.walk_counts``);
- ``pack_total``: ``pipeline.pack_host``, the ``rjt.pack`` part of
  ``pipeline.pack_group``: the banked tables and the lanes packed into a
  ``Stager`` of the staging pool, without the upload (host);
- ``pack_bits+bookkeep`` (mug, dri0): ``pack_total`` minus ``walk``;
- ``h2d``: ``pipeline.upload_group``, the ``Stager``'s one pinned copy
  and the group's tensor views, with its bytes (device time, and the
  upload's host time apart);
- ``wave``, ``transform``, ``epilogue``: K1, K2 and K3 (NATIVE) on the
  staged group;
- ``device_limit``: K1 -> K2 -> K3 on the staged group, as
  ``pipeline.decode_group_device_entropy`` runs them: the leg's rate were
  the host free.

Host stages are timed on the host clock (``perf_counter``), with the
process's CPU time beside it (``process_time``, every thread of the pack
pool included), each rep the mean of as many calls as fill 0.2 s: a
stage's ``host_cores`` is its CPU time over its wall time. Device stages are timed by CUDA events on the current stream (the
decoder's), recorded after a spin of the device long enough for the host
to queue the stage, so the events bracket device work alone; on the CPU
(``--device cpu``) by the host clock. A stage's ``ceiling_mpix_s`` is the
leg's Mpix a call over its ms: the rate were it the only bound. Before
anything is timed, the ``device_limit`` chain's channels of the first
frame must equal ``Decoder.decode_batched``'s byte for byte.

Each leg's ``model``: host core-ms an image (``pack_total``'s CPU time and
the upload call's wall time, over the batch; parse is once a stream, outside the decode
loop), device ms an image (``device_limit``), the device limit in Mpix/s,
the host-bound ceiling on this process's usable cores, and the host cores
that would feed the device limit (on mug and dri0 the root tool's N-core
walk model: the walk is most of the host side, an image a core). The stages overlap in the main path (the
pack pool, two chunks in flight), so their sum is not a call's time; each
leg also records one warm ``decode_batched`` call, ended by a synchronize,
beside them, with its paths and its index walk's chunks by walker.

Writes the record ``ROOFLINE_TORCH_r<N>.json`` (the next free N at the
checkout's root; ``ROOFLINE_OUT`` names another path) with
the card (name and power limit) and the host (CPU model, usable cores),
and prints it as one JSON line. Runs on the card unless given ``--device
cpu``; a leg that fails makes the tool exit 1 and write nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .. import api, pipeline
from ..ops import pack, staging
from ..types import DecodeParams, OutputFormat
from . import bench, common

OUT_ENV = "ROOFLINE_OUT"
LEGS = ("headline", "dri0")  # dri0 gives way to mug where the image is
_WALKED = ("parse", "walk", "pack_total", "pack_bits+bookkeep", "h2d", "wave",
           "transform", "epilogue", "device_limit")
STAGES = {
    "headline": ("parse", "pack_total", "h2d", "wave", "transform",
                 "epilogue", "device_limit"),
    "dri0": _WALKED,
    "mug": _WALKED,
}
# Seconds of calls a rep of a host stage takes: a process CPU clock may
# tick in milliseconds, so one call of a few ms can read as no time.
HOST_WINDOW_S = 0.2
# Device cycles spun before a timed device stage (about 4 ms at the H100's
# clock): the host queues the stage meanwhile.
HEAD_START_CYCLES = 8_000_000
FMT = OutputFormat.NATIVE


class ProfileError(RuntimeError):
    """A leg failed: its chain disagreed with ``decode_batched``, or its
    process exited non-zero or printed no result."""


def legs() -> tuple:
    """The legs profiled: headline and mug, or dri0 in mug's place where
    the bench's mug image is absent."""
    return ("headline", "mug") if bench.mug_present() else LEGS


def reps() -> int:
    return int(os.environ.get("PROF_REPS", "3"))


def _host(fn, n: int) -> dict:
    """``fn`` once warm, then ``n`` reps, each as many calls as fill
    :data:`HOST_WINDOW_S`: the median over the reps of the wall ms and the
    process CPU ms a call."""
    fn()
    wall, cpu = [], []
    for _ in range(n):
        calls = 0
        c0, t0 = time.process_time(), time.perf_counter()
        while True:
            fn()
            calls += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= HOST_WINDOW_S:
                break
        wall.append(elapsed * 1e3 / calls)
        cpu.append((time.process_time() - c0) * 1e3 / calls)
    return {"ms": statistics.median(wall), "cpu_ms": statistics.median(cpu),
            "calls_a_rep": calls}


def _device(device, fn, n: int, setup=lambda: None) -> float:
    """``fn(setup())`` once warm, then ``n`` times: the median ms of
    ``fn`` alone (``setup`` is not timed), by CUDA events on the current
    stream behind a head start on the card, by the host clock on the
    CPU."""
    fn(setup())
    times = []
    for _ in range(n):
        arg = setup()
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(HEAD_START_CYCLES)
            start.record()
            fn(arg)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn(arg)
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def first_image_channels(g: pipeline.GroupInputs, plist) -> list:
    """The ``device_limit`` chain on a staged group: the first frame's
    channels as host arrays. Raises ProfileError when a lane flagged."""
    per_image, err = pipeline.decode_group_device_entropy(g, plist, FMT)
    if bool(err.any()):
        raise ProfileError("the device_limit chain flagged a decode error")
    return [ch.cpu().numpy() for ch, _pitch in per_image[0]]


def check_chain(streams, g, plist, device) -> None:
    """Hold the chain's first frame against ``decode_batched``'s, byte for
    byte (the same frames through the session API's device-entropy
    path)."""
    got = first_image_channels(g, plist)
    dec = api.Decoder(device=device, device_entropy="on")
    img = dec.decode_batched(streams, DecodeParams(FMT))[0]
    want = [ch.cpu().numpy() for ch in img.channel if ch is not None]
    dec.synchronize()
    if len(got) != len(want) or any(
            a.shape != b.shape or not np.array_equal(a, b)
            for a, b in zip(got, want)):
        raise ProfileError("the device_limit chain's first frame differs "
                           "from decode_batched's")


def _stage(ms: float, mpix: float, cores, **extra) -> dict:
    return dict(ms=ms, host_cores=cores,
                ceiling_mpix_s=mpix / ms * 1e3 if ms > 0 else None, **extra)


def _host_stage(t: dict, mpix: float, **extra) -> dict:
    return _stage(t["ms"], mpix, t["cpu_ms"] / t["ms"], cpu_ms=t["cpu_ms"],
                  calls_a_rep=t["calls_a_rep"], **extra)


def run_leg(leg: str, device: torch.device) -> dict:
    """Every stage of ``leg`` in this process; returns the leg's
    figures."""
    s = bench.settings(leg)
    blobs, mpix, _fmt = bench.leg_corpus(leg, s["batch"], s["w"], s["h"],
                                         s["ri_mcus"])
    n, batch = reps(), len(blobs)
    vk = api.VIRTUAL_SYMBOLS if "walk" in STAGES[leg] else None
    for mod in bench.KERNELS.values():
        mod.launches = 0
    streams = [api.JpegStream(b) for b in blobs]
    plist = [st.params for st in streams]
    g = pipeline.pack_group(plist, device, None, vk)
    check_chain(streams, g, plist, device)
    bench._log(f"[{leg}] device_limit chain: the first frame's channels "
               "equal decode_batched's")

    stages = {}
    t = _host(lambda: [api.JpegStream(b) for b in blobs], n)
    stages["parse"] = _host_stage(t, mpix)
    if vk:
        def walk():
            _scans, tokens = pack.index_walk(plist, vk)
            for token in tokens:
                staging.walk_buffer_pool().release(token)
        t = _host(walk, n)
        pack.reset_walk_counts()
        walk()
        stages["walk"] = _host_stage(t, mpix, walkers=pack.walk_counts())

    def pack_total():
        with staging.Stager(device) as st:
            pipeline.pack_host(st, plist, None, vk)
    t = _host(pack_total, n)
    stages["pack_total"] = _host_stage(t, mpix)
    if vk:
        w, p = stages["walk"], stages["pack_total"]
        ms = p["ms"] - w["ms"]
        stages["pack_bits+bookkeep"] = _stage(
            ms, mpix, (p["cpu_ms"] - w["cpu_ms"]) / ms if ms > 0 else None,
            cpu_ms=p["cpu_ms"] - w["cpu_ms"])

    host_upload = []

    def packed():
        st = staging.Stager(device)
        return st, pipeline.pack_host(st, plist, None, vk)

    def upload(arg):
        st, host = arg
        t0 = time.perf_counter()
        up = pipeline.upload_group(st, *host)
        host_upload.append((time.perf_counter() - t0) * 1e3)
        return up

    ms = _device(device, upload, n, packed)
    stages["h2d"] = _stage(
        ms, mpix, 0, bytes=g.packed.dense.untyped_storage().nbytes(),
        host_ms=statistics.median(host_upload[1:]),
        note="one pinned copy a group; host_ms is the upload call's wall "
             "time on its one thread")
    coeffs, _err = pipeline.wave_group(g)
    stages["wave"] = _stage(
        _device(device, lambda _: pipeline.wave_group(g), n), mpix, 0)
    planes = pipeline.transform_group(g, coeffs)
    stages["transform"] = _stage(_device(
        device, lambda _: pipeline.transform_group(g, coeffs), n), mpix, 0)
    del coeffs
    stages["epilogue"] = _stage(_device(
        device, lambda _: pipeline._per_image(plist[0], planes, FMT, None,
                                              batch), n), mpix, 0)
    del planes
    stages["device_limit"] = _stage(_device(
        device, lambda _: pipeline.decode_group_device_entropy(
            g, plist, FMT), n), mpix, 0)

    # One warm call through the session API, for comparison.
    dec = api.Decoder(device=device, device_entropy=s["entropy"],
                      check_errors=False)
    params = DecodeParams(FMT)
    call = []
    for _ in range(n + 1):
        pack.reset_walk_counts()
        t0 = time.perf_counter()
        dec.decode_batched(streams, params)
        dec.synchronize()
        call.append((time.perf_counter() - t0) * 1e3)
    paths = [p for p, _ in dec.last_paths]
    walkers = pack.walk_counts()
    return {"leg": leg, "batch": batch, "w": plist[0].picture_width,
            "h": plist[0].picture_height,
            "mpix_per_iter": mpix, "vsyms": vk, "reps": n,
            "scan_bytes": sum(len(p.slice_data) for p in plist) / batch,
            "stages": stages, "model": model(stages, batch, mpix),
            "call": {"ms": statistics.median(call[1:]), "paths": paths,
                     "walkers": walkers,
                     "sum_of_stages_ms": sum(
                         stages[k]["ms"] for k in ("pack_total", "h2d",
                                                   "device_limit"))},
            "device_limit_equal": True,
            "launches": {k: m.launches for k, m in bench.KERNELS.items()}}


def model(stages: dict, batch: int, mpix: float) -> dict:
    """Host core-ms and device ms an image, and what they imply."""
    host = (stages["pack_total"]["cpu_ms"] + stages["h2d"]["host_ms"]) / batch
    dev = stages["device_limit"]["ms"] / batch
    cores = len(os.sched_getaffinity(0))
    mpix_img = mpix / batch
    return {
        "host_core_ms_per_img": host,
        "device_ms_per_img": dev,
        "device_limit_mpix_s": stages["device_limit"]["ceiling_mpix_s"],
        "host_bound_ceiling_this_machine": cores / host * 1e3 * mpix_img,
        "usable_cores": cores,
        "host_cores_for_device_limit": host / dev,
        "process_time_resolution_s": time.get_clock_info(
            "process_time").resolution,
        "note": "parse excluded (once a stream); the host side is "
                "pack_total's process CPU time and the upload call's wall "
                "time; ceilings assume perfect overlap of host and device",
    }


def run_leg_process(leg: str, device) -> dict:
    """``leg`` in a process of its own (this module with ``PROF_LEG``);
    raises ProfileError when it fails or prints no result."""
    proc = subprocess.run(
        [sys.executable, "-m", "rocjpeg_tpu_torch.tools.profile_stages",
         "--device", str(device)], env=bench.package_env({"PROF_LEG": leg}),
        stdout=subprocess.PIPE, text=True, timeout=bench.LEG_TIMEOUT_S)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise ProfileError(f"leg {leg}: its process exited "
                           f"{proc.returncode}")
    return json.loads(lines[-1])


def report(leg: dict) -> None:
    bench._log(f"== {leg['leg']} ({leg['batch']} frames, "
               f"{leg['mpix_per_iter']:.1f} Mpix a call) ==")
    for name, st in leg["stages"].items():
        ceil = st["ceiling_mpix_s"]
        bench._log(f"  {name:<20}{st['ms']:>10.3f} ms{st['ms'] / leg['batch']:>9.3f}"
                   f" ms/img  ceiling "
                   f"{'-' if ceil is None else f'{ceil:.1f}'} Mpix/s")
        if "walkers" in st:
            bench._log(f"  {'':<20}chunks by walker: "
                       f"{ {k: v for k, v in st['walkers'].items() if v} }")
    m = leg["model"]
    bench._log(f"  model: host {m['host_core_ms_per_img']:.3f} core-ms/img, "
               f"device {m['device_ms_per_img']:.3f} ms/img, device limit "
               f"{m['device_limit_mpix_s']:.1f} Mpix/s; "
               f"{m['host_cores_for_device_limit']:.2f} host cores would "
               f"feed it (this process: {m['usable_cores']} cores, ceiling "
               f"{m['host_bound_ceiling_this_machine']:.1f} Mpix/s); one "
               f"warm call {leg['call']['ms']:.3f} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-d", "--device", type=common._device_arg, default=0,
                    help="CUDA device id (default 0), or 'cpu' to run every "
                         "kernel's plain PyTorch version on the host")
    args = ap.parse_args(argv)
    leg = os.environ.get("PROF_LEG")
    try:
        device = bench.resolve_device(args.device)
        if leg:
            with (torch.cuda.device(device) if device.type == "cuda"
                  else contextlib.nullcontext()):
                res = run_leg(leg, device)
            report(res)
            print(json.dumps(res), flush=True)
            return 0
        out = os.environ.get(OUT_ENV) or bench.next_record("ROOFLINE_TORCH")
        names = legs()
        results = {name: run_leg_process(name, args.device)
                   for name in names}
    except (bench.BenchError, ProfileError) as exc:
        print(f"profile_stages FAILED: {exc}", file=sys.stderr)
        return 1
    record = {"metric": "per-stage ms and ceilings of the main path, "
                        f"median of {reps()} warm reps a stage",
              "legs": results, "device": bench.device_info(device),
              "host": bench.host_info(),
              "corpus": (f"the bench's headline and mug legs (tools/bench.py"
                         f" leg_corpus); mug: {bench.MUG_COPIES} copies of "
                         f"{bench.MUG_PATH}" if "mug" in names else
                         "the bench's headline and dri0 legs "
                         "(tools/bench.py leg_corpus); dri0 stands in for "
                         "the root's mug image, which is not in the "
                         "repository")}
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    bench._log(f"[stages] wrote {out}")
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
