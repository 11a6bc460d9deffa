"""The control of the correctness check: the plain reference put in the
program's place with libjpeg's lower-precision integer IDCT ("ifast",
``jidctfst.c``) in place of the exact one, at the cell's own size. Its
numbers must fail the check's limits; the upper reading of each limit is
the smallest this gives.

    python3 benchmark/control.py --workload uhd420.dri0 --seeds 1 2 3

For each seed it builds the cell's corpus as a run does, decodes the
images of as many batches as a run checks (the configuration's
``check_calls``) with the control, and compares them with the exact
reference as a run compares the program's outputs. Prints one JSON line
a seed. Runs on the host's cores; the card is not used.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def control_numbers(cell, seed: int, idct: str = "ifast") -> dict:
    from harness import check, corpus, pool
    fmt = cell.mix["format"]
    path = check.reference_path(cell.bench_dir, cell.config)
    with pool.pool() as workers:
        batches = corpus.finish(*corpus.start(cell.config, cell.mix, seed,
                                              workers))
        jobs = [(path, cell.config, seed, im, fmt, idct)
                for b in batches[:int(cell.config["check_calls"])]
                for im in b.images]
        return check.summary(workers.map(check.control_job, jobs,
                                         chunksize=1), 0)


def main(argv=None) -> int:
    from harness import check, spec
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--idct", default="ifast")
    a = ap.parse_args(argv)
    cell = spec.cell(a.workload)
    for seed in a.seeds:
        t0 = time.time()
        nums = control_numbers(cell, seed, a.idct)
        correct, _ = check.verdict(nums)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "idct": a.idct, "correct": correct,
                          "numbers": nums, "took_s": time.time() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
