"""Multi-process scaling of the port's main path, the counterpart of the
root ``tools/scaling.py``.

    python -m rocjpeg_tpu_torch.tools.scaling [-d N|cpu]

Each worker is a process of its own, pinned to a core set of its own
(``os.sched_setaffinity``: the usable cores split evenly), that decodes its
own ``SCALING_FRAMES`` frames (default 8) of the bench's headline corpus
(``BENCH_W`` x ``BENCH_H`` 4:2:0, a restart marker every ``BENCH_RI_MCUS``
MCUs; worker r takes frames 8r to 8r + 7) with
``dist.sharding.MeshDecoder.decode_batched_local`` on a mesh of its one
device, ``device_entropy="auto"``, NATIVE: the main path at full width.
After a warm-up call it waits for one wall-clock epoch that the parent
hands every worker of a run once all are warm, then times
``SCALING_ITERS`` calls (default 8). No call may flag an image, and the
last call's images must equal the warm-up's, whose SHA-256 digests the
record keeps.

A trial is three runs: one solo process (on the first core set), then
:data:`PROCS` (2) independent processes, the control, and as many
joined by ``dist.multihost.initialize``, whose rate comes from
``allreduce_metrics``:

- ``efficiency_layout`` = distributed / independent: the cost of the
  distributed layer alone;
- ``efficiency_raw`` = distributed / (N x solo);
- ``contention_factor`` = independent / (N x solo): what the processes
  lose to sharing the machine (host cores, memory, the card).

The distributed run also times ``PROBE_CALLS`` ``all_reduce`` calls of a
two-element tensor on the process group (the only collective the port's
layout makes) and reports their mean, averaged over the processes.
Devices: with ``--device cpu`` every worker on the host under gloo; with
at least as many cards as processes, one card a worker under NCCL;
otherwise every worker on the one card under gloo (NCCL cannot put two
ranks on one card; gloo reduces the metrics on the host). The record
``SCALING_TORCH_r<N>.json`` (the next free N at the checkout's root;
``SCALING_OUT`` names another path) holds
``SCALING_TRIALS`` trials (default 3), each efficiency's values and
median, the layout, every worker's digests, paths and launches, the card
(name and power limit) and the host (CPU model, usable cores). Runs on the
card unless given ``--device cpu``; a worker that fails makes the tool
exit 1 and write nothing.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import torch

from ..testing import corpus
from . import bench, common

OUT_ENV = "SCALING_OUT"
PROCS = 2  # processes of the independent and the distributed run
PROBE_CALLS = 50
RUN_TIMEOUT_S = 900.0  # seconds a run's workers may take, warm-up included
_WORKER = ("import sys; from rocjpeg_tpu_torch.tools import scaling; "
           "sys.exit(scaling.worker(sys.argv[1]))")


class ScalingError(RuntimeError):
    """A worker failed, printed no result or ran past RUN_TIMEOUT_S."""


def settings() -> dict:
    s = bench.settings()
    return {
        "procs": PROCS,
        "trials": int(os.environ.get("SCALING_TRIALS", "3")),
        "iters": int(os.environ.get("SCALING_ITERS", "8")),
        "frames": int(os.environ.get("SCALING_FRAMES", "8")),
        "w": s["w"], "h": s["h"], "ri_mcus": s["ri_mcus"],
    }


def corpus_frames(cfg: dict) -> list:
    """Every worker's frames, worker r's at [r * frames, (r + 1) *
    frames): the bench's headline corpus of ``procs * frames`` frames."""
    return corpus.build_corpus(cfg["procs"] * cfg["frames"], cfg["w"],
                               cfg["h"], ri_mcus=cfg["ri_mcus"])


def layout(nproc: int, device) -> tuple:
    """(device a worker, process-group backend) for ``nproc`` workers."""
    if device == "cpu":
        return ["cpu"] * nproc, "gloo"
    if nproc > 1 and torch.cuda.device_count() >= nproc:
        return [f"cuda:{r}" for r in range(nproc)], "nccl"
    return [f"cuda:{device}"] * nproc, "gloo"


def core_sets(nproc: int) -> list:
    """The usable cores split evenly into ``nproc`` disjoint sets."""
    cores = sorted(os.sched_getaffinity(0))
    share = len(cores) // nproc
    if share < 1:
        raise ScalingError(f"{nproc} workers cannot each have a core of "
                           f"their own: {len(cores)} usable cores")
    return [cores[r * share:(r + 1) * share] for r in range(nproc)]


def digest(chans) -> str:
    return hashlib.sha256(b"".join(c.tobytes() for c in chans)).hexdigest()


def worker(spec_json: str) -> int:
    """One worker (a process of its own): see the module docstring.
    Prints ``READY`` once warm, reads the epoch from stdin, and prints
    ``RESULT <json>``."""
    spec = json.loads(spec_json)
    os.sched_setaffinity(0, spec["cores"])
    import torch.distributed as dist
    from .. import api
    from ..dist import mesh, multihost, sharding
    from ..types import DecodeParams, OutputFormat
    joined = spec["distributed"] and spec["nproc"] > 1
    if joined:
        multihost.initialize(spec["address"], spec["nproc"], spec["rank"],
                             backend=spec["backend"])
    device = torch.device(spec["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    lo, hi = spec["frames"]
    blobs = corpus.build_corpus(spec["n_corpus"], spec["w"], spec["h"],
                                ri_mcus=spec["ri_mcus"])[lo:hi]
    streams = [api.JpegStream(b) for b in blobs]
    md = sharding.MeshDecoder(mesh.make_mesh(devices=[device]),
                              device_entropy="auto", check_errors=False)
    params = DecodeParams(OutputFormat.NATIVE)
    for mod in bench.KERNELS.values():
        mod.launches = 0
    per_image, _pitches, err = md.decode_batched_local(streams, params)
    if err.any():
        raise ScalingError(f"worker {spec['rank']}: the warm-up flagged "
                           f"images {err.nonzero()[0].tolist()}")
    digests = [digest(chans) for chans in per_image]
    print("READY", flush=True)
    epoch = float(sys.stdin.readline())
    while time.time() < epoch:
        time.sleep(0.0005)
    flags = []
    t0 = time.perf_counter()
    for _ in range(spec["iters"]):
        per_image, _pitches, err = md.decode_batched_local(streams, params)
        flags.append(err)
    secs = time.perf_counter() - t0
    if any(err.any() for err in flags) or [
            digest(c) for c in per_image] != digests:
        raise ScalingError(f"worker {spec['rank']}: a timed call flagged "
                           "an image, or the last one's images differ from "
                           "the warm-up's")
    images = spec["iters"] * len(streams)
    mpix = spec["iters"] * sum(s.params.picture_width
                               * s.params.picture_height
                               for s in streams) / 1e6
    result = {"rank": spec["rank"], "device": str(device),
              "cores": spec["cores"], "torch_threads": torch.get_num_threads(),
              "frames": [lo, hi], "images": images, "mpix": mpix,
              "seconds": secs, "rate": images / secs, "digests": digests,
              "paths": [p for p, _ in md.last_paths],
              "launches": {k: m.launches for k, m in bench.KERNELS.items()}}
    if joined:
        result["backend"] = dist.get_backend()
        result["reduced"] = multihost.allreduce_metrics(images, mpix, secs)
        x = torch.zeros(2, dtype=torch.float64,
                        device=multihost.reduce_device())

        def settle():
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
        dist.all_reduce(x)
        settle()
        t0 = time.perf_counter()
        for _ in range(PROBE_CALLS):
            dist.all_reduce(x)
        settle()
        probe = (time.perf_counter() - t0) / PROBE_CALLS
        result["probe_s"] = multihost.allreduce_metrics(
            0.0, probe, 0.0)[1] / spec["nproc"]
    md.close()
    if joined:
        dist.destroy_process_group()
    print("RESULT " + json.dumps(result), flush=True)
    return 0


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run(nproc: int, distributed: bool, cfg: dict, devices, backend,
        cores) -> dict:
    """``nproc`` workers started together, released on one epoch once
    all are warm; returns the run's images/s (the reduced rate when
    distributed, else the sum of the workers') and their results. Every
    worker is stopped whatever happens."""
    address = f"127.0.0.1:{_free_port()}"
    env = bench.package_env({})
    procs, logs = [], []
    for rank in range(nproc):
        spec = dict(rank=rank, nproc=nproc, address=address,
                    distributed=distributed, backend=backend,
                    device=devices[rank], cores=cores[rank],
                    n_corpus=cfg["procs"] * cfg["frames"],
                    frames=[rank * cfg["frames"], (rank + 1) * cfg["frames"]],
                    w=cfg["w"], h=cfg["h"], ri_mcus=cfg["ri_mcus"],
                    iters=cfg["iters"])
        logs.append(tempfile.TemporaryFile("w+"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, json.dumps(spec)], env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=logs[-1],
            text=True))
    watchdog = threading.Timer(RUN_TIMEOUT_S,
                               lambda: [p.kill() for p in procs])
    watchdog.start()

    def failed(what):
        for log in logs:
            log.seek(0)
        tails = "\n".join(log.read()[-3000:] for log in logs)
        return ScalingError(f"{what}\n{tails}")

    try:
        for p in procs:
            for line in p.stdout:
                if line.strip() == "READY":
                    break
            else:
                raise failed(f"a worker exited {p.wait()} before its "
                             "warm-up ended")
        epoch = time.time() + 0.25
        for p in procs:
            p.stdin.write(f"{epoch!r}\n")
            p.stdin.close()
        results = []
        for p in procs:
            out = p.stdout.read()
            p.wait()
            lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            if p.returncode != 0 or not lines:
                raise failed(f"a worker exited {p.returncode}"
                             f"{'' if lines else ' with no result'}")
            results.append(json.loads(lines[-1][len("RESULT "):]))
    finally:
        watchdog.cancel()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if distributed and nproc > 1:
        images, _mpix, secs = results[0]["reduced"]
        rate = images / secs
    else:
        rate = sum(r["rate"] for r in results)
    return {"rate": rate, "workers": results,
            "probe_ms": (results[0]["probe_s"] * 1e3
                         if "probe_s" in results[0] else None)}


def trial(cfg: dict, device) -> dict:
    """One solo, one independent and one distributed run."""
    n = cfg["procs"]
    devices, backend = layout(n, device)
    cores = core_sets(n)
    solo = run(1, False, cfg, devices, backend, cores)
    indep = run(n, False, cfg, devices, backend, cores)
    joined = run(n, True, cfg, devices, backend, cores)
    rates = {"1_proc_solo": solo["rate"], f"{n}_proc_independent":
             indep["rate"], f"{n}_proc_distributed": joined["rate"]}
    return {**rates,
            "efficiency_layout": joined["rate"] / indep["rate"],
            "efficiency_raw": joined["rate"] / (n * solo["rate"]),
            "contention_factor": indep["rate"] / (n * solo["rate"]),
            "dispatch_probe_ms_per_call": joined["probe_ms"],
            "runs": {"solo": solo["workers"], "independent": indep["workers"],
                     "distributed": joined["workers"]}}


def measure(device) -> dict:
    """Every trial; returns the record's measurements."""
    cfg = settings()
    t0 = time.perf_counter()
    corpus_frames(cfg)  # encoded (or found) once, before any worker starts
    bench._log(f"[scaling] {cfg['procs']} x {cfg['frames']} frames "
               f"{cfg['w']}x{cfg['h']} ready in "
               f"{time.perf_counter() - t0:.1f} s")
    devices, backend = layout(cfg["procs"], device)
    trials = []
    for k in range(cfg["trials"]):
        t = trial(cfg, device)
        bench._log(f"[scaling] trial {k + 1}/{cfg['trials']}: "
                   + ", ".join(f"{name} {t[name]:.4f}" for name in t
                               if name != "runs"))
        trials.append(t)
    out = {"metric": "multi-process scaling efficiency (images/s)",
           "settings": cfg, "trials": trials,
           "layout": {"devices": devices, "backend": backend,
                      "cores": core_sets(cfg["procs"])}}
    for key in ("efficiency_layout", "efficiency_raw", "contention_factor",
                "dispatch_probe_ms_per_call"):
        vals = [t[key] for t in trials]
        out[f"{key}_all"] = vals
        out[f"{key}_median"] = statistics.median(vals)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-d", "--device", type=common._device_arg, default=0,
                    help="CUDA device id (default 0), or 'cpu' to run every "
                         "kernel's plain PyTorch version on the host")
    args = ap.parse_args(argv)
    out = os.environ.get(OUT_ENV) or bench.next_record("SCALING_TORCH")
    try:
        dev = bench.resolve_device(args.device)
        record = measure(args.device)
    except (bench.BenchError, ScalingError) as exc:
        print(f"scaling FAILED: {exc}", file=sys.stderr)
        return 1
    record.update(
        device=bench.device_info(dev), host=bench.host_info(),
        method="solo, N independent (the control) and N distributed "
               "processes, each pinned to its own core set, each timing "
               "its own frames from one shared wall-clock epoch; "
               "efficiency_layout = distributed / independent isolates the "
               "distributed layer from what the processes lose to sharing "
               "the machine (contention_factor)")
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    bench._log(f"[scaling] wrote {out}")
    print(json.dumps({k: v for k, v in record.items() if k != "trials"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
