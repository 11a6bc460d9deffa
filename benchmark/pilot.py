"""Run one cell several times, one process a run, and report the spread of
each metric as the benchmark's bounds are judged.

    python3 benchmark/pilot.py --workload uhd420.dri0 --seconds 50 \\
        --seeds 11 12 13 14 15 16 [--clients 3 2] [--trace 0] [--out F]

Each run is ``benchmark/run.py`` with the same arguments; for each seed
every client count runs in turn, the k-th count with the seed plus
1000 k. The spread of a metric is the distance between the first
and third quartiles (``statistics.quantiles(values, n=4)``) over the
median, leaving out the run farthest from the median where that narrows
it. Every result line is appended to ``--out`` (JSON lines).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def spread(values: list) -> float:
    """Quartile distance over the median, without the run farthest from
    the median where leaving it out narrows it."""
    def one(v):
        q = statistics.quantiles(v, n=4)
        return (q[2] - q[0]) / statistics.median(v)
    if len(values) < 3:
        return float("nan")
    best = one(values)
    if len(values) >= 4:
        med = statistics.median(values)
        far = max(range(len(values)), key=lambda i: abs(values[i] - med))
        best = min(best, one(values[:far] + values[far + 1:]))
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--clients", type=int, nargs="+", default=[0],
                    help="client counts to compare, in turns (0: the mix's)")
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    lines = []
    turns = [(seed + k * 1000, clients) for seed in a.seeds
             for k, clients in enumerate(a.clients)]
    for seed, clients in turns:
        cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload",
               a.workload, "--seed", str(seed), "--seconds", str(a.seconds),
               "--trace", str(a.trace)]
        if clients:
            cmd += ["--clients", str(clients)]
        t0 = time.time()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        took = time.time() - t0
        tail = proc.stderr.strip().splitlines()[-12:]
        out = proc.stdout.strip().splitlines()
        line = json.loads(out[-1]) if proc.returncode == 0 and out else None
        rec = {"workload": a.workload, "seed": seed, "clients": clients,
               "seconds": a.seconds, "trace": a.trace, "rc": proc.returncode,
               "took_s": took, "line": line, "stderr_tail": tail}
        lines.append(rec)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        ms = {k: v["value"] for k, v in (line or {}).get("metrics",
                                                        {}).items()}
        layers = [t for t in tail if t.startswith("[window]")]
        print(f"[pilot] {a.workload} seed {seed} clients {clients} rc "
              f"{proc.returncode} {took:.1f}s correct "
              f"{(line or {}).get('correct')} {json.dumps(ms)} "
              f"{' '.join(layers)}", flush=True)
        if proc.returncode != 0 or line is None:
            print("\n".join(proc.stderr.strip().splitlines()[-40:]),
                  flush=True)
    for clients in a.clients:
        good = [r["line"] for r in lines
                if r["line"] and r["clients"] == clients]
        names = sorted({k for g in good for k in g["metrics"]})
        for k in names:
            vals = [g["metrics"][k]["value"] for g in good
                    if k in g["metrics"]]
            print(f"[pilot] {a.workload} clients {clients} {k}: median "
                  f"{statistics.median(vals)} spread {spread(vals):.4f} "
                  f"values {vals}", flush=True)
    return 0 if all(r["line"] for r in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
