"""Time each design step of K1 (the wave kernel) alone, on the card.

    python3 -m rocjpeg_tpu_torch.kernels.k1_steps [--out FILE.json]

``csrc/wave.cu`` keeps its design steps behind ``RJT_WAVE_*`` macros. This
script builds one library per variant (all nvcc runs started together),
routes ``wave.wave_decode`` through each, checks that every variant gives
the output of the package's own build, and times them by CUDA events at the
two main-path groups of the smoke run (8 frames of 3840x2160 4:2:0: 65,024
restart lanes, and 9,216 virtual lanes of a DRI=0 corpus). Variants are
timed in turns, forward then backward, and the median over all turns is
reported, so a drift of the card's clocks spreads over all of them. Two
times are taken: "call" has the events around one wrapper call on an idle
card, so it holds the host's work before the first launch as well; "queued"
has them around ten calls queued back to back, divided by ten, which is
the device's time per call once the host runs ahead of it.

"first" is the design of the kernel's first version: one 2-byte store per
coefficient into an output that is zero-filled beforehand, a 16-step code
search, no word loaded ahead, 128 threads a block, block state looked up
at every step. Each "+..." variant adds one step to it; each "all but ..."
or "all, ..." takes one step from the package's build or changes it. Last,
the two flushes are timed on the restart corpus cut to 1, 2 and 4 frames:
where they cross is where the kernel switches (``kWarpFlushWarpsPerSm``).
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import statistics
import subprocess

import torch

from .. import api, pipeline
from ..core.bitstream import JpegStreamParser
from ..testing import corpus
from . import build, wave

FIRST = {"RJT_WAVE_FLUSH": 0, "RJT_WAVE_LUT_BITS": 0, "RJT_WAVE_PREFETCH": 0,
         "RJT_WAVE_THREADS": 128, "RJT_WAVE_BLOCK_AHEAD": 0}
VARIANTS = {
    "first": FIRST,
    "+tile, own flush": {**FIRST, "RJT_WAVE_FLUSH": 1},
    "+tile, warp flush": {**FIRST, "RJT_WAVE_FLUSH": 2},
    "+threads by lanes": {**FIRST, "RJT_WAVE_THREADS": 0},
    "+table 9 bits": {**FIRST, "RJT_WAVE_LUT_BITS": 9},
    "+word ahead, register": {**FIRST, "RJT_WAVE_PREFETCH": 1},
    "+words ahead, cp.async": {**FIRST, "RJT_WAVE_PREFETCH": 2},
    "+block state ahead": {**FIRST, "RJT_WAVE_BLOCK_AHEAD": 1},
    "all but tile": {"RJT_WAVE_FLUSH": 0},
    "all, own flush": {"RJT_WAVE_FLUSH": 1},
    "all, warp flush": {"RJT_WAVE_FLUSH": 2},
    "all but block state ahead": {"RJT_WAVE_BLOCK_AHEAD": 0},
    "all, 128 threads": {"RJT_WAVE_THREADS": 128},
    "all but table": {"RJT_WAVE_LUT_BITS": 0},
    "all, table 8 bits": {"RJT_WAVE_LUT_BITS": 8},
    "all but words ahead": {"RJT_WAVE_PREFETCH": 0},
    "all, word ahead in a register": {"RJT_WAVE_PREFETCH": 1},
    "all": {},
}
REPS = 10  # per turn; two turns


def _defines(macros):
    return tuple(f"{k}={v}" for k, v in sorted(macros.items()))


def _wave_args(blobs, virtual_k):
    plist = [JpegStreamParser().parse(b) for b in blobs]
    g = pipeline.pack_group(plist, "cuda", virtual_k=virtual_k)
    dp = g.packed
    return (dp.dense, dp.word_off, dp.img_base, dp.mcu_start, dp.mcu_count,
            dp.lane_bank, g.lentab, g.values, g.geom, dp.n_words,
            g.max_steps)


def _event_ms(fn, calls=1):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the table as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_steps: torch.cuda.is_available() is false")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(
            lambda m: build.load(_defines(m)), VARIANTS.values())))
    restart = corpus.build_corpus(8, 3840, 2160, ri_mcus=4)
    groups = {
        "restart": _wave_args(restart, None),
        "dri0": _wave_args(corpus.build_corpus(8, 3840, 2160, seed=1,
                                               ri_mcus=0),
                           api.VIRTUAL_SYMBOLS),
    }
    table = {}
    for gname, wargs in groups.items():
        build.use(None)
        want, want_err = wave.wave_decode(*wargs)
        times = {name: [] for name in VARIANTS}
        queued = {name: [] for name in VARIANTS}
        for name, lib in libs.items():
            build.use(lib)
            out, err = wave.wave_decode(*wargs)  # also the warm-up
            if not (torch.equal(out, want) and torch.equal(err, want_err)):
                raise AssertionError(f"variant {name!r} differs on {gname}")
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                build.use(libs[name])
                wave.wave_decode(*wargs)
                times[name] += [_event_ms(lambda: wave.wave_decode(*wargs))
                                for _ in range(REPS)]
                queued[name] += [_event_ms(lambda: wave.wave_decode(*wargs),
                                           REPS) for _ in range(3)]
        build.use(None)
        table[gname] = {name: {"call": statistics.median(times[name]),
                               "queued": statistics.median(queued[name])}
                        for name in VARIANTS}
        print(f"K1 on the {gname} group ({wargs[1].shape[0]} lanes, "
              f"max_steps {wargs[-1]}), ms by CUDA events: one wrapper call "
              f"(median of {2 * REPS}), and per call of {REPS} queued back "
              "to back (median of 6):", flush=True)
        for name, ms in table[gname].items():
            print(f"  {name:32s} {ms['call']:.4f}  {ms['queued']:.4f}",
                  flush=True)
    # Where the two flushes cross: the restart corpus cut to fewer frames.
    crossover = {}
    for frames in (1, 2, 4):
        wargs = _wave_args(restart[:frames], None)
        row = {}
        for name in ("all, own flush", "all, warp flush"):
            build.use(libs[name])
            wave.wave_decode(*wargs)
            row[name] = statistics.median(
                _event_ms(lambda: wave.wave_decode(*wargs), REPS)
                for _ in range(6))
        build.use(None)
        crossover[wargs[1].shape[0]] = row
        print(f"restart lanes of {frames} frame(s), {wargs[1].shape[0]} "
              f"lanes, queued ms: {row}", flush=True)
    result = {"card": card, "reps": 2 * REPS, "ms": table,
              "crossover_ms": crossover,
              "variants": {n: _defines(m) for n, m in VARIANTS.items()}}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
