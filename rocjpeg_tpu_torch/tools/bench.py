"""Throughput bench of the port on one card, the counterpart of the JAX
package's root ``bench.py``: its legs, its model of load and its
regression gate.

    python -m rocjpeg_tpu_torch.tools.bench [-d N|cpu] [--records DIR]

Five legs, each in a process of its own, so that no two share a caching
allocator, a staging pool or a peak-memory counter:

- ``headline``: ``BENCH_BATCH`` synthesized photo-like ``BENCH_W`` x
  ``BENCH_H`` 4:2:0 frames with a restart marker every ``BENCH_RI_MCUS``
  MCUs, NATIVE (real restart lanes, path ``'wave'``);
- ``dri0``: frames of the same content without restart markers, NATIVE
  (the host index walk and virtual restart lanes, ``'wave-virtual'``);
- ``mug``: 32 copies of the JAX bench's reference image
  (:data:`MUG_PATH`, 3840x2160 4:2:0 without restart markers), run only
  when that file exists, as the root bench runs it; ``BENCH_BATCH``,
  ``BENCH_W`` and ``BENCH_H`` do not apply;
- ``mixed``: half the batch at ``BENCH_W`` x ``BENCH_H`` and half at
  1920x1088, each frame with one of two Huffman table sets: two shape
  groups a call, each decoded on table banks;
- ``rgb``: the headline frames as packed RGB.

A leg's process parses its streams once and makes one warm-up call. Then
it times ``BENCH_REPS`` reps of ``BENCH_ITERS`` ``decode_batched`` calls of
the whole batch, shared among ``BENCH_THREADS`` submitter threads that
share one ``Decoder(check_errors=False)``. A thread keeps at most two of its
calls in flight: it dispatches call i, then waits for the CUDA event
recorded after call i-1, never for the whole device. A rep's time runs on
the host clock from the threads' start to a ``torch.cuda.synchronize()``
after they join. The leg's rate is the median rep's Mpix/s. Each thread
keeps the device error flags of each of its calls, which are read after
the timing; a flagged call fails the leg. The leg also reports the peak
device memory of the timed reps (``torch.cuda.max_memory_allocated``),
the paths of the warm-up call's chunks, the launches of K1, K2 and K3
in its process, and its index walk's chunks by walker
(``ops.pack.walk_counts``: the DRI=0 walk's, ``narrowed`` where a SIMD
walker handed a chunk back).

Prints one JSON line on stdout: the headline's Mpix/s as ``value``, each
other leg's rate, each leg's figures and the card (its name and power
limit as ``nvidia-smi`` reports them, and the count of cards); diagnostics
go to stderr. A leg that fails, or runs past :data:`LEG_TIMEOUT_S`, makes
the tool exit 1 after the other legs have run, and no line is printed. The tool
runs on the card unless it is given ``--device cpu``; without a card it
fails. The regression gate (:func:`check_regressions`) holds each rate
against the port's earlier records of the same card and power limit.

Environment knobs, with the root bench's names and defaults:
``BENCH_BATCH`` (16), ``BENCH_W`` (3840), ``BENCH_H`` (2160),
``BENCH_ITERS`` (16), ``BENCH_REPS`` (3), ``BENCH_FMT`` (native; the rgb
leg is RGB), ``BENCH_RI_MCUS`` (4), ``BENCH_ENTROPY`` (auto),
``BENCH_THREADS`` (4, 3 for dri0 and mug), ``BENCH_EXTRAS`` (0: the headline leg
alone) and ``BENCH_LEG`` (run this one leg in this process and print its
line). The corpora are cached by ``testing.corpus`` (``BENCH_CORPUS_CACHE``).
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import platform
import re
import statistics
import subprocess
import sys
import threading
import time

import torch

from .. import api
from ..core.bitstream import JpegStreamParser
from ..kernels import build as kbuild
from ..kernels import epilogue, transform, wave
from ..ops import pack
from ..testing import corpus
from ..types import DecodeParams, OutputFormat
from . import common

METRIC = "Mpixels/sec/card batched 4:2:0 decode"
LEGS = ("headline", "dri0", "mug", "mixed", "rgb")  # the root bench's order
# The result's key of each leg's Mpix/s, as the root bench names them.
LEG_KEYS = {"headline": "value", "dri0": "dri0_mpix_s",
            "mug": "mug420_mpix_s", "mixed": "mixed_mpix_s",
            "rgb": "rgb_mpix_s"}
# The mug leg's image, where the root bench reads it; the leg runs only
# when the file exists (root bench.py:396-398).
MUG_PATH = "/root/reference/data/images/mug_420.jpg"
# Frames a call of the mug leg: with DRI=0 the host walk bounds the leg,
# and 32 streams a chunk walk on one core as one 32-stream AVX-512 chunk
# (root bench.py:432-437).
MUG_COPIES = 32
# The mixed leg's second shape, as the root bench has it.
MIXED_FRAME = (1920, 1088)
KERNELS = {"wave": wave, "transform": transform, "epilogue": epilogue}
RECORD = re.compile(r"^BENCH_TORCH_r(\d+)\.json$")
LEG_TIMEOUT_S = 900.0  # seconds a leg's process may take


class BenchError(RuntimeError):
    """A leg failed: a decode flagged on the device, a submitter thread's
    exception, or a leg's process that exited non-zero or ran too long."""


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def settings(leg: str = "headline") -> dict:
    """The environment knobs of ``leg``, with the root bench's defaults."""
    return {
        "batch": int(os.environ.get("BENCH_BATCH", "16")),
        "w": int(os.environ.get("BENCH_W", "3840")),
        "h": int(os.environ.get("BENCH_H", "2160")),
        "iters": int(os.environ.get("BENCH_ITERS", "16")),
        "reps": int(os.environ.get("BENCH_REPS", "3")),
        "fmt": os.environ.get("BENCH_FMT", "native"),
        "ri_mcus": int(os.environ.get("BENCH_RI_MCUS", "4")),
        "entropy": os.environ.get("BENCH_ENTROPY", "auto"),
        "threads": int(os.environ.get(
            "BENCH_THREADS", "3" if leg in ("dri0", "mug") else "4")),
        "extras": os.environ.get("BENCH_EXTRAS", "1") != "0",
    }


def leg_corpus(leg: str, n_images: int, w: int, h: int, ri_mcus: int,
               fmt_name: str = "native") -> tuple:
    """A leg's frames, as the root bench builds them: (blobs, Mpix a call,
    output format). ``fmt_name`` is the format of every leg but rgb. The
    mug leg reads :data:`MUG_PATH` and takes its size from the stream;
    without the file it raises BenchError."""
    fmt = common.FMT_NAMES[fmt_name]
    mpix = n_images * w * h / 1e6
    if leg == "mug":
        blob = mug_image()
        p = JpegStreamParser().parse(blob)
        blobs = [blob] * MUG_COPIES
        mpix = MUG_COPIES * p.picture_width * p.picture_height / 1e6
    elif leg in ("headline", "rgb"):
        blobs = corpus.build_corpus(n_images, w, h, ri_mcus=ri_mcus)
        if leg == "rgb":
            fmt = OutputFormat.RGB
    elif leg == "dri0":
        blobs = corpus.build_corpus(n_images, w, h, seed=1, ri_mcus=0)
    elif leg == "mixed":
        half = n_images // 2
        mw, mh = MIXED_FRAME
        blobs = (corpus.build_corpus(half, w, h, seed=2, ri_mcus=ri_mcus,
                                     mixed_tables=True)
                 + corpus.build_corpus(half, mw, mh, seed=3,
                                       ri_mcus=ri_mcus, mixed_tables=True))
        mpix = (half * w * h + half * mw * mh) / 1e6
    else:
        raise BenchError(f"unknown leg {leg!r}; the legs are "
                         f"{', '.join(LEGS)}")
    return blobs, mpix, fmt


def mug_image() -> bytes:
    """The bytes of :data:`MUG_PATH`; BenchError when it cannot be read."""
    try:
        with open(MUG_PATH, "rb") as f:
            return f.read()
    except OSError as exc:
        raise BenchError(f"the mug leg reads {MUG_PATH}: {exc}") from exc


def mug_present() -> bool:
    """Whether the mug leg runs: the root bench's test of its image."""
    return os.path.exists(MUG_PATH)


def legs_here(legs=LEGS) -> list:
    """The legs of ``legs`` that run on this machine: mug only where its
    image exists."""
    return [leg for leg in legs if leg != "mug" or mug_present()]


def resolve_device(device) -> torch.device:
    """``-d``'s value as a torch device: ``"cpu"``, or a CUDA index that
    must name a card of this machine."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise BenchError("no CUDA card: torch.cuda.is_available() is false "
                         "(pass --device cpu to bench the host)")
    if not 0 <= device < torch.cuda.device_count():
        raise BenchError(f"no CUDA card {device}: this machine has "
                         f"{torch.cuda.device_count()}")
    return torch.device("cuda", device)


def device_info(device: torch.device):
    """``"cpu"``, or the card: its name (torch), its power limit
    (``nvidia-smi``, None where that cannot be read) and the count of
    cards."""
    if device.type == "cpu":
        return "cpu"
    power = None
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index}"],
            capture_output=True, text=True, check=True, timeout=60)
        power = smi.stdout.strip().splitlines()[0].rsplit(",", 1)[1].strip()
    except (OSError, IndexError, subprocess.SubprocessError) as exc:
        _log(f"bench: nvidia-smi gave no power limit ({exc})")
    return {"name": torch.cuda.get_device_name(device),
            "power_limit": power, "count": torch.cuda.device_count()}


def host_info() -> dict:
    """The host: its CPU model as ``/proc/cpuinfo`` names it (else
    ``platform``), its vendor, family and model numbers and which of AVX2
    and AVX-512 it has (a virtual machine may name its model "unknown"),
    the cores this process may run on (``os.sched_getaffinity``) and the
    machine's core count."""
    cpu = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first processor's block
                key, _, value = line.partition(":")
                cpu[key.strip()] = value.strip()
    except OSError:
        pass
    flags = cpu.get("flags", "").split()
    return {"cpu": cpu.get("model name") or platform.processor() or None,
            "cpu_id": " ".join(f"{k} {cpu[k]}" for k in (
                "vendor_id", "cpu family", "model") if k in cpu) or None,
            "isa": [f for f in ("avx2", "avx512f") if f in flags],
            "usable_cores": len(os.sched_getaffinity(0)),
            "cpu_count": os.cpu_count()}


def next_record(stem: str, records_dir: str | None = None) -> str:
    """The path of the next record ``<stem>_r<N>.json`` (N one past the
    highest there, from 01) in ``records_dir``: by default the checkout's
    root, or the current directory for an installed package."""
    root = records_dir or kbuild.checkout_root() or os.getcwd()
    pat = re.compile(rf"^{re.escape(stem)}_r(\d+)\.json$")
    taken = [int(m.group(1)) for n in os.listdir(root)
             for m in [pat.match(n)] if m]
    return os.path.join(root, f"{stem}_r{max(taken, default=0) + 1:02d}.json")


def _flagged(errs) -> bool:
    return any(bool(e.any()) for e in errs)


def run_config(name: str, decoder, blobs, params, iters: int, n_threads: int,
               mpix_iter: float, reps: int) -> dict:
    """Time one leg on ``decoder``: a warm-up call, then ``reps`` reps of
    ``iters`` calls of the whole batch shared among ``n_threads``
    submitter threads, each with at most two of its calls in flight.
    Returns the leg's figures; raises BenchError when a thread raised or
    any call (the warm-up's included) flagged a decode error."""
    streams = [api.JpegStream(b) for b in blobs]
    for mod in KERNELS.values():
        mod.launches = 0
    pack.reset_walk_counts()
    t0 = time.perf_counter()
    imgs = decoder.decode_batched(streams, params)
    device = imgs[0].channel[0].device
    cuda = device.type == "cuda"
    decoder.synchronize()
    if _flagged(decoder.last_error_flags):
        raise BenchError(f"[{name}] the warm-up call flagged a decode error")
    del imgs
    chunks = [p for p, _ in decoder.last_paths]
    images = collections.Counter()
    for p, idxs in decoder.last_paths:
        images[p] += len(idxs)
    _log(f"[{name}] warm-up {time.perf_counter() - t0:.3f} s; entropy "
         f"paths (images) {dict(images)}, chunks {chunks}")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    per = [iters // n_threads + (1 if t < iters % n_threads else 0)
           for t in range(n_threads)]
    rates, flags = [], []
    for rep in range(reps):
        calls = [[] for _ in range(n_threads)]  # each call's flags
        failures = []

        def worker(tid):
            try:
                inflight = collections.deque()
                for _ in range(per[tid]):
                    out = decoder.decode_batched(streams, params)
                    calls[tid].append(decoder.last_error_flags)
                    done = None
                    if cuda:
                        done = torch.cuda.Event()
                        done.record(torch.cuda.current_stream(device))
                    inflight.append((out, done))
                    if len(inflight) > 1:
                        _old, old_done = inflight.popleft()
                        if old_done is not None:
                            old_done.synchronize()
            except Exception as exc:  # raised again after the join
                failures.append(exc)

        threads = [threading.Thread(target=worker, args=(t,),
                                    name=f"bench-{name}-{t}")
                   for t in range(n_threads)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if cuda:
            torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - t0
        if failures:
            raise BenchError(f"[{name}] a submitter thread raised "
                             f"{failures[0]!r}") from failures[0]
        flags.append(calls)
        rate = iters * mpix_iter / elapsed
        _log(f"[{name}] rep {rep + 1}/{reps}: {iters} calls x {len(blobs)} "
             f"images on {n_threads} threads in {elapsed:.4f} s "
             f"({iters * len(blobs) / elapsed:.1f} images/s, {rate:.1f} "
             f"Mpix/s)")
        rates.append(rate)
    decoder.synchronize()
    # The flags, read after the timing: every call of every thread.
    for rep, calls in enumerate(flags, 1):
        for tid, errs in enumerate(calls):
            for k, err in enumerate(errs, 1):
                if _flagged(err):
                    raise BenchError(f"[{name}] rep {rep}, thread {tid}, "
                                     f"call {k}: a decode error flagged on "
                                     f"the device")
    res = {"mpix_s": statistics.median(rates), "reps_mpix_s": rates,
           "threads": n_threads, "iters": iters, "reps": reps,
           "images": len(blobs), "mpix_per_call": mpix_iter,
           "paths": chunks,
           "launches": {k: mod.launches for k, mod in KERNELS.items()},
           "walkers": pack.walk_counts(),
           "peak_mib": (torch.cuda.max_memory_allocated(device) / 2 ** 20
                        if cuda else None)}
    walked = {k: v for k, v in res["walkers"].items() if v}
    _log(f"[{name}] median of {reps}: {res['mpix_s']:.1f} Mpix/s; launches "
         f"(K1, K2, K3) {list(res['launches'].values())}; index walk "
         f"chunks {walked}; peak device "
         f"memory {res['peak_mib']} MiB")
    return res


def run_leg(leg: str, device: torch.device) -> dict:
    """One leg in this process: its corpus, its decoder and its figures."""
    s = settings(leg)
    t0 = time.perf_counter()
    blobs, mpix, fmt = leg_corpus(leg, s["batch"], s["w"], s["h"],
                                  s["ri_mcus"], s["fmt"])
    kib = sum(map(len, blobs)) / len(blobs) / 1024
    _log(f"[{leg}] corpus: {len(blobs)} images, {mpix:.1f} Mpix a call, "
         f"4:2:0, {fmt.name}, {kib:.0f} KiB on average, ready in "
         f"{time.perf_counter() - t0:.1f} s")
    decoder = api.Decoder(device=device, device_entropy=s["entropy"],
                          check_errors=False)
    res = run_config(leg, decoder, blobs, DecodeParams(output_format=fmt),
                     s["iters"], s["threads"], mpix, s["reps"])
    res.update(leg=leg, format=fmt.name, entropy=s["entropy"],
               torch_threads=torch.get_num_threads(),
               device=device_info(device))
    return res


def package_env(extra: dict) -> dict:
    """This process's environment with ``extra`` over it, for a process
    that runs a module of the package: in a checkout, ``PYTHONPATH``
    leads with the checkout, so the package is found from any cwd."""
    env = dict(os.environ, **extra)
    root = kbuild.checkout_root()
    if root is not None:
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def run_leg_process(leg: str, device, env=None) -> dict:
    """``leg`` in a process of its own (this module with ``BENCH_LEG``,
    and ``env``'s variables over this process's); its diagnostics pass
    through to stderr. Raises BenchError when the process exits non-zero,
    prints no line or runs past :data:`LEG_TIMEOUT_S` (it is then
    killed)."""
    env = package_env(dict(env or {}, BENCH_LEG=leg))
    argv = [sys.executable, "-m", "rocjpeg_tpu_torch.tools.bench",
            "--device", str(device)]
    try:
        proc = subprocess.run(argv, env=env, stdout=subprocess.PIPE,
                              text=True, timeout=LEG_TIMEOUT_S)
    except subprocess.TimeoutExpired as exc:
        raise BenchError(f"leg {leg}: no result within {LEG_TIMEOUT_S:g} "
                         f"s; its process was killed") from exc
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise BenchError(f"leg {leg}: its process exited {proc.returncode}"
                         f"{'' if lines else ' and printed no result'}")
    return json.loads(lines[-1])


def _record_round(name: str) -> int:
    return int(RECORD.match(name).group(1))


def _same_card(a, b) -> bool:
    """Two results' ``device``: both ``"cpu"``, or cards of one name and
    one power limit."""
    if isinstance(a, dict) and isinstance(b, dict):
        return (a.get("name"), a.get("power_limit")) == (
            b.get("name"), b.get("power_limit"))
    return isinstance(a, str) and a == b


def check_regressions(result: dict, threshold: float = 0.8,
                      best_threshold: float = 0.85,
                      records_dir: str | None = None) -> bool:
    """The regression gate: hold every leg's rate in ``result`` against the
    most recent and the best of the port's records ``BENCH_TORCH_r<N>.json``
    in ``records_dir`` (default: the checkout's root, or the current
    directory for an installed package) whose ``device`` is ``result``'s:
    the same card name and power limit. Records of another card, and the
    JAX package's ``BENCH_r<N>.json``, are never read. A leg regresses
    below ``threshold`` x the previous record or ``best_threshold`` x the
    best; prints the trajectory to stderr and returns True when any leg
    regressed."""
    root = records_dir or kbuild.checkout_root() or os.getcwd()
    names = sorted((os.path.basename(p) for p in glob.glob(
        os.path.join(root, "BENCH_TORCH_r*.json"))
        if RECORD.match(os.path.basename(p))), key=_record_round)
    history = []  # (record name, its result)
    for name in names:
        try:
            with open(os.path.join(root, name)) as f:
                rec = json.load(f)
        except (OSError, ValueError) as exc:
            _log(f"[regression gate] {name} unreadable ({exc}); skipped")
            continue
        if not isinstance(rec, dict):
            continue
        if not _same_card(rec.get("device"), result.get("device")):
            _log(f"[regression gate] {name} is of {rec.get('device')}, "
                 f"not this run's card; not compared")
            continue
        history.append((name, rec))
    if not history:
        return False
    prev_name, prev = history[-1]
    rows, regressed = [], False
    for leg, key in LEG_KEYS.items():
        new_v = result.get(key)
        if new_v is None:
            continue
        traj = [(n, d[key]) for n, d in history if d.get(key)]
        old_v = prev.get(key)
        best_n, best_v = max(traj, key=lambda t: t[1]) if traj else (None,
                                                                     None)
        flags = []
        if old_v and new_v / old_v < threshold:
            flags.append(f"REGRESSION vs previous ({new_v / old_v:.2f}x)")
        if best_v and new_v / best_v < best_threshold:
            flags.append(f"REGRESSION vs best {best_n} "
                         f"({new_v / best_v:.2f}x)")
        regressed = regressed or bool(flags)
        tr = " -> ".join(f"{v:.0f}" for _, v in traj) or "-"
        rows.append(f"  {leg:<10} previous {old_v or 0:>9.1f}  best "
                    f"{best_v or 0:>9.1f}  now {new_v:>9.1f} Mpix/s  [{tr}]"
                    f"  {'; '.join(flags) or 'ok'}")
    _log(f"[regression gate] vs {prev_name} and the best of "
         f"{len(history)} record(s) of this card:")
    for row in rows:
        _log(row)
    if regressed:
        _log("!! BENCH REGRESSION (see the gate above)")
    return regressed


def run_legs(device, records_dir=None) -> dict:
    """Every leg (the headline alone with ``BENCH_EXTRAS=0``; mug only
    when :data:`MUG_PATH` exists) in a process of its own, then the gate;
    returns the result line's object, or raises BenchError naming every
    leg that failed."""
    legs = legs_here(LEGS if settings()["extras"] else LEGS[:1])
    results, failed = {}, []
    for leg in legs:
        try:
            results[leg] = run_leg_process(leg, device)
        except BenchError as exc:
            _log(f"[{leg}] FAILED: {exc}")
            failed.append(str(exc))
    if failed:
        raise BenchError("; ".join(failed))
    result = {"metric": METRIC}
    for leg in legs:
        result[LEG_KEYS[leg]] = results[leg]["mpix_s"]
        if leg == "headline":
            result["unit"] = "Mpixel/s"
    result["legs"] = {leg: {k: v for k, v in res.items()
                            if k not in ("leg", "device")}
                      for leg, res in results.items()}
    result["device"] = results[legs[0]]["device"]
    result["regressed"] = check_regressions(result, records_dir=records_dir)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-d", "--device", type=common._device_arg, default=0,
                    help="CUDA device id (default 0), or 'cpu' to run every "
                         "kernel's plain PyTorch version on the host")
    ap.add_argument("--records", default=None,
                    help="directory of the port's BENCH_TORCH_r<N>.json "
                         "records (default: the checkout's root, or the "
                         "current directory for an installed package)")
    args = ap.parse_args(argv)
    leg = os.environ.get("BENCH_LEG")
    try:
        device = resolve_device(args.device)
        result = (run_leg(leg, device) if leg else
                  run_legs(args.device, args.records))
    except BenchError as exc:
        print(f"bench FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
