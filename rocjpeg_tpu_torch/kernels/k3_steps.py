"""Time each design step of K3 (the output epilogue) alone, on the card.

    python3 -m rocjpeg_tpu_torch.kernels.k3_steps [--out FILE.json]

``csrc/epilogue.cu`` keeps its first version (one pixel a thread, byte
loads and byte stores into shared memory, one row segment a block) behind
``RJT_EPI_BASELINE`` and the steps of its design behind ``RJT_EPI_*``
macros: how full groups are loaded (8 bytes at a time, shifted words,
bytes), the register cap that decides how many blocks a SM holds, row pairs
under vertical subsampling, rows a block, staging buffers and columns a
tile (the package's build picks the last two by mode: planar RGB takes
tiles of 4096 and one buffer, the rest 2048 and two). This script builds
one library per variant (all nvcc runs started together), routes
``epilogue.render`` through each, checks that every variant gives the bytes
of the plain version, and times them by CUDA events
on random planes of the main-path shape (8 frames of 3840x2160): interleaved
RGB, planar RGB and NV12's UV plane from 4:2:0 planes, packed YUYV from 4:2:2
planes, interleaved RGB from 4:4:4 planes, and RGB from 4:2:0 planes through
an ROI whose left edge is odd (shifted words at best). The time is per
call of ten calls queued back to back behind a few milliseconds of
``torch.cuda._sleep``, so it is the device's even where the wrapper's host
work outlasts the kernel. Variants are timed in turns, forward then
backward, and the median over all turns is reported, so a drift of the
card's clocks spreads over all of them.

Last, renders into caller destinations (``decode_into``'s route), which only
the design takes in one launch: NV12 (Y copied, UV computed) and planar YUV
(three copies) of 4:2:0 planes, beside one strided ``copy_`` per image and
crop-only channel (and the first version's launch for the UV plane), which
is what the wrapper did before the kernel had its copy parts (timed here,
used nowhere in the package). Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import statistics
import subprocess

import torch

from ..ops.postprocess import CHROMA_FACTORS
from ..types import (ChromaSubsampling, CropRectangle, DecodedImage,
                     OutputFormat)
from . import build, epilogue

CSS = ChromaSubsampling
F = OutputFormat
VARIANTS = {
    "first version": {"RJT_EPI_BASELINE": 1},
    "all, bytes for words": {"RJT_EPI_WORDS": 0},
    "all, shifted words": {"RJT_EPI_WORDS": 1},
    "all, registers not capped": {"RJT_EPI_MIN_BLOCKS": 1},
    "all, registers for 4 blocks a SM": {"RJT_EPI_MIN_BLOCKS": 4},
    "all, registers for 8 blocks a SM": {"RJT_EPI_MIN_BLOCKS": 8},
    "all but row pairs": {"RJT_EPI_PAIR": 0},
    "all, strips of 1 row (or pair)": {"RJT_EPI_STRIP": 1,
                                       "RJT_EPI_COPY_STRIP": 8},
    "all, strips of 2 rows": {"RJT_EPI_STRIP": 2, "RJT_EPI_COPY_STRIP": 8},
    "all, strips of 8 rows": {"RJT_EPI_STRIP": 8, "RJT_EPI_COPY_STRIP": 8},
    "all, strips of 16 rows": {"RJT_EPI_STRIP": 16, "RJT_EPI_COPY_STRIP": 8},
    "all, copy strips of 4 rows": {"RJT_EPI_COPY_STRIP": 4},
    "all, copy strips of 16 rows": {"RJT_EPI_COPY_STRIP": 16},
    "all, one staging buffer": {"RJT_EPI_BUFFERS": 1},
    "all, tiles of 1024": {"RJT_EPI_TILE": 1024},
    "all, tiles of 2048, two buffers": {"RJT_EPI_TILE": 2048,
                                        "RJT_EPI_BUFFERS": 2},
    "all, tiles of 4096, one buffer": {"RJT_EPI_TILE": 4096,
                                       "RJT_EPI_BUFFERS": 1},
    "all": {},
}
BATCH, WIDTH, HEIGHT = 8, 3840, 2160
ODD_LEFT = CropRectangle(1, 1, WIDTH, HEIGHT)  # 3839 x 2159 at (1, 1)
CASES = {  # name -> (subsampling, format, crop)
    "RGB 4:2:0": (CSS.CSS_420, F.RGB, None),
    "planar RGB 4:2:0": (CSS.CSS_420, F.RGB_PLANAR, None),
    "NV12 UV 4:2:0": (CSS.CSS_420, F.NATIVE, None),
    "YUYV 4:2:2": (CSS.CSS_422, F.NATIVE, None),
    "RGB 4:4:4": (CSS.CSS_444, F.RGB, None),
    "RGB 4:2:0, ROI at (1, 1)": (CSS.CSS_420, F.RGB, ODD_LEFT),
}
DEST_CASES = {
    "NV12 into destinations (Y copied, UV computed)": F.NATIVE,
    "planar YUV into destinations (3 copies)": F.YUV_PLANAR,
}
HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet
HEAD_START_CYCLES = 8_000_000  # about 4 ms of torch.cuda._sleep
CALLS = 10  # queued per timing
RUNS = 5    # timings per turn; two turns


def _defines(macros):
    return tuple(f"{k}={v}" for k, v in sorted(macros.items()))


def random_planes(css, batch=BATCH, width=WIDTH, height=HEIGHT, seed=0):
    """MCU-padded random uint8 planes (y, u, v) on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    hf, vf = CHROMA_FACTORS[css]
    pw, ph = -(-width // (8 * hf)) * 8 * hf, -(-height // (8 * vf)) * 8 * vf
    return tuple(torch.randint(0, 256, shape, dtype=torch.uint8,
                               device="cuda", generator=gen)
                 for shape in ((batch, ph, pw),
                               *[(batch, ph // vf, pw // hf)] * 2))


def queued_ms(fn):
    """Time per call of CALLS calls queued behind a busy card."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HEAD_START_CYCLES)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / CALLS


def in_turns(fns):
    """{name: median ms} of {name: (setup, fn)}: after its setup each fn is
    timed RUNS times, all in order, then all in reverse order."""
    times = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            setup, fn = fns[name]
            setup()
            fn()
            times[name] += [queued_ms(fn) for _ in range(RUNS)]
    return {name: statistics.median(t) for name, t in times.items()}


def _dests(channels):
    """One destination per image for batched (tensor, pitch) channels, rows
    64 bytes apart from the next."""
    dests = []
    for i in range(channels[0][0].shape[0]):
        d = DecodedImage.empty()
        for ci, (arr, _pitch) in enumerate(channels):
            d.pitch[ci] = arr.shape[2] + 64
            d.channel[ci] = torch.zeros(arr.shape[1] * d.pitch[ci],
                                        dtype=torch.uint8, device="cuda")
        dests.append(d)
    return dests


def _windows(dests, ci, like):
    return [d.channel[ci].as_strided(tuple(like.shape[1:]), (d.pitch[ci], 1))
            for d in dests]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the tables as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k3_steps: torch.cuda.is_available() is false")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(
            lambda m: build.load(_defines(m)), VARIANTS.values())))
    table, bounds = {}, {}
    for cname, (css, fmt, crop) in CASES.items():
        planes = random_planes(css)
        rargs = (css, planes, WIDTH, HEIGHT, fmt, crop)
        want = epilogue.render_reference(*rargs)
        eff_w, eff_h = ((WIDTH, HEIGHT) if crop is None
                        else (crop.width, crop.height))
        mode, plan = epilogue.channel_plan(css, fmt, eff_w, eff_h)
        for name, lib in libs.items():
            build.use(lib)
            for (a, _), (b, _) in zip(epilogue.render(*rargs), want):
                if not torch.equal(a, b):
                    raise AssertionError(f"variant {name!r} differs on "
                                         f"{cname}")
        # Every computed channel written once, and the ROI of every plane
        # they are computed from read once.
        hf, vf = CHROMA_FACTORS[css]
        moved = sum(a.numel() for (a, _), ch in zip(want, plan)
                    if ch.plane is None)
        moved += BATCH * ((0 if mode == epilogue.MODE_UV else eff_w * eff_h)
                          + 2 * (eff_w // hf) * (eff_h // vf))
        bounds[cname] = moved / HBM_BYTES_PER_S * 1e3
        del want
        table[cname] = in_turns({
            name: (lambda lib=lib: build.use(lib),
                   lambda: epilogue.render(*rargs))
            for name, lib in libs.items()})
        build.use(None)
        print(f"K3 {cname}, {BATCH} x {WIDTH}x{HEIGHT}: {moved} bytes, bound "
              f"{bounds[cname]:.4f} ms at {HBM_BYTES_PER_S / 1e12} TB/s; ms "
              f"per call of {CALLS} queued (median of {2 * RUNS}), and the "
              "bound's share of it:", flush=True)
        for name, ms in table[cname].items():
            print(f"  {name:34s} {ms:.4f}  {bounds[cname] / ms:.3f}",
                  flush=True)
        del planes

    # Into caller destinations: one launch of the design, beside one copy_
    # per image and crop-only channel.
    css = CSS.CSS_420
    planes = random_planes(css)
    dest_table = {}
    for cname, fmt in DEST_CASES.items():
        build.use(libs["all"])
        want = epilogue.render_reference(css, planes, WIDTH, HEIGHT, fmt)
        _mode, plan = epilogue.channel_plan(css, fmt, WIDTH, HEIGHT)
        dests = _dests(want)
        before = epilogue.launches
        epilogue.render(css, planes, WIDTH, HEIGHT, fmt, None, dests)
        if epilogue.launches - before != 1:
            raise AssertionError(f"{cname}: not one launch")
        for ci, (b, _) in enumerate(want):
            for win, img in zip(_windows(dests, ci, b), b):
                if not torch.equal(win, img):
                    raise AssertionError(f"{cname}: channel {ci} differs")
        copies = [(win, img) for ci, ((b, _), ch) in enumerate(zip(want, plan))
                  if ch.plane is not None
                  for win, img in zip(_windows(dests, ci, b), b)]

        def before():
            # What the wrapper did: the first version's launch for a
            # computed channel (here into a tensor of its own), one copy_
            # per image for each crop-only channel.
            if fmt == F.NATIVE:
                epilogue.render(css, planes, WIDTH, HEIGHT, fmt)
            for win, img in copies:
                win.copy_(img)

        # Copies read and write their channel; the UV plane reads U and V.
        moved = sum(b.numel() + (b.numel() if ch.plane is not None else
                                 planes[1].numel() + planes[2].numel())
                    for (b, _), ch in zip(want, plan))
        into = lambda: epilogue.render(css, planes, WIDTH, HEIGHT, fmt, None,
                                       dests)
        row = in_turns({
            f"first version and {len(copies)} copy_ calls": (
                lambda: build.use(libs["first version"]), before),
            **{name: (lambda lib=lib: build.use(lib), into)
               for name, lib in libs.items() if name != "first version"}})
        bound = moved / HBM_BYTES_PER_S * 1e3
        dest_table[cname] = {"ms": row, "bound_ms": bound, "bytes": moved}
        print(f"K3 {cname}: {moved} bytes, bound {bound:.4f} ms; ms per "
              f"call of {CALLS} queued, and the bound's share of it:",
              flush=True)
        for name, ms in row.items():
            print(f"  {name:34s} {ms:.4f}  {bound / ms:.3f}", flush=True)
        del dests, want, copies
    build.use(None)
    result = {"card": card, "calls": CALLS, "runs": 2 * RUNS, "ms": table,
              "bound_ms": bounds, "dests": dest_table,
              "variants": {n: _defines(m) for n, m in VARIANTS.items()}}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
