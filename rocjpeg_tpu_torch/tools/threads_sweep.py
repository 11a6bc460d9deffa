"""Submitter-thread sweep of the port's bench, the counterpart of the root
``tools/threads_sweep.py``.

    python -m rocjpeg_tpu_torch.tools.threads_sweep [-d N|cpu]

For every leg of ``THREADS_LEGS`` (default ``headline,mug`` as in the root
tool when the bench's mug image, ``bench.MUG_PATH``, exists, else
``headline,dri0``: the dri0 leg, 3840x2160 4:2:0 frames without restart
markers, stands in for it) and every submitter-thread
count of ``THREADS_SET`` (default ``1,2,3,4``), one point: the bench's leg
(``tools/bench.py``) in a fresh process of its own with ``BENCH_THREADS``
set, whose rate is the median of its ``BENCH_REPS`` reps (default 3), the
bench's own discipline. The other ``BENCH_*`` knobs are the bench's. Each
leg's corpus is encoded once, here, into the bench's cache under
``kernels.build.build_dir()``; every point's process reads it back.

Writes the record ``THREADS_TORCH_r<N>.json`` (the next free N at the
checkout's root; ``THREADS_OUT`` names another path) and
prints it as one JSON line: for each leg, Mpix/s at every thread count and
the best count, and each point's reps, peak device memory, chunk paths,
K1-K3 launches, index walk chunks by walker and the torch intra-op
thread count of its process; the corpus it read (``corpus``); the
card (name and power limit) and the host (CPU model, usable cores). Runs
on the card unless given ``--device cpu``; a point whose process fails
makes the tool exit 1 and write nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import bench, common

OUT_ENV = "THREADS_OUT"


def sweep_settings() -> dict:
    """The sweep's knobs: its legs, thread counts and reps a point."""
    default = "headline,mug" if bench.mug_present() else "headline,dri0"
    return {
        "legs": os.environ.get("THREADS_LEGS", default).split(","),
        "threads": [int(t) for t in
                    os.environ.get("THREADS_SET", "1,2,3,4").split(",")],
        "reps": bench.settings()["reps"],
    }


def encode_corpora(legs) -> None:
    """Each leg's frames, encoded (or found) once in the bench's cache."""
    for leg in legs:
        s = bench.settings(leg)
        t0 = time.perf_counter()
        blobs, mpix, _fmt = bench.leg_corpus(leg, s["batch"], s["w"],
                                             s["h"], s["ri_mcus"])
        bench._log(f"[sweep] {leg}: {len(blobs)} frames, {mpix:.1f} Mpix a "
                   f"call, ready in {time.perf_counter() - t0:.1f} s")


def sweep(device) -> dict:
    """Every leg at every thread count, a fresh process a point; returns
    the record. Raises BenchError when a point's process fails."""
    cfg = sweep_settings()
    encode_corpora(cfg["legs"])
    legs = {}
    for leg in cfg["legs"]:
        points = {}
        for t in cfg["threads"]:
            res = bench.run_leg_process(leg, device,
                                        env={"BENCH_THREADS": str(t)})
            points[str(t)] = {k: res[k] for k in (
                "mpix_s", "reps_mpix_s", "threads", "iters", "images",
                "peak_mib", "paths", "launches", "walkers",
                "torch_threads")}
            bench._log(f"[sweep] {leg} threads={t}: {res['mpix_s']:.1f} "
                       f"Mpix/s (reps {res['reps_mpix_s']})")
        rates = {t: p["mpix_s"] for t, p in points.items()}
        legs[leg] = {"threads": rates, "best": int(max(rates,
                                                       key=rates.get)),
                     "points": points}
    dev = bench.resolve_device(device)
    return {
        "metric": f"Mpix/s vs submitter threads on one Decoder (each point "
                  f"the median of {cfg['reps']} reps in a fresh process)",
        "reps": cfg["reps"], "legs": legs,
        "settings": {k: v for k, v in bench.settings().items()
                     if k not in ("threads", "extras")},
        "torch_threads": sorted({p["torch_threads"] for leg in legs.values()
                                 for p in leg["points"].values()}),
        "device": bench.device_info(dev), "host": bench.host_info(),
        "corpus": "the bench's legs (tools/bench.py leg_corpus); " + (
            f"mug: {bench.MUG_COPIES} copies of {bench.MUG_PATH}"
            if "mug" in cfg["legs"] else
            "dri0 (seed 1, no restart markers) stands in for the root's "
            "mug image, which is not in the repository"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-d", "--device", type=common._device_arg, default=0,
                    help="CUDA device id (default 0), or 'cpu' to run every "
                         "kernel's plain PyTorch version on the host")
    args = ap.parse_args(argv)
    out = os.environ.get(OUT_ENV) or bench.next_record("THREADS_TORCH")
    try:
        bench.resolve_device(args.device)
        record = sweep(args.device)
    except bench.BenchError as exc:
        print(f"threads_sweep FAILED: {exc}", file=sys.stderr)
        return 1
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    bench._log(f"[sweep] wrote {out}")
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
