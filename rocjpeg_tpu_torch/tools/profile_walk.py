"""Micro-profile of the host index walk that feeds K1 on DRI=0 frames, the
counterpart of the root ``tools/profile_walk.py``.

    python -m rocjpeg_tpu_torch.tools.profile_walk [-d N|cpu]

Host-only. The input is ``N`` copies (default 16) of the bench's mug image
(``bench.MUG_PATH``), as in the root tool, or, where that file is absent,
of the first frame of the bench's dri0 corpus (``tools/bench.py``
``leg_corpus``: ``BENCH_W`` x ``BENCH_H`` 4:2:0 without restart markers,
seed 1), standing in for it; the record's ``corpus`` says which. Each stage is warmed
once and timed ``REPS`` times (default 5), as the main path runs it; its
figure is the best rep, in ms, ms an image and MB/s of scan bytes:

- ``unstuff``: ``runtime.native.unstuff`` of one scan;
- ``index_scan8`` on 8 copies, ``index_scan16`` on 16 and
  ``index_scan32`` on 32 where ``N`` allows and
  ``native.index_scan16_available()`` says the host has AVX-512, each on
  the pooled buffer sets of ``staging.walk_buffer_pool()``, with
  ``VSYMS`` symbols a virtual lane (default ``api.VIRTUAL_SYMBOLS``). The
  AVX-512 walkers address the clean streams by 32-bit offsets from the
  lowest and refuse sets spread wider (the main path then walks the chunk
  in halves, counted ``narrowed``). The pool lays a set's clean streams
  out in one slab, so it should never be refused; a refusal is recorded
  with the sets' span. Each AVX-512 walker is also timed on sets this
  tool carves from one allocation of its own (``one slab``), which the
  pool's row should match;
- ``index_scan8 split``: the copies in chunks of 8, side by side on
  ``staging.pack_pool()``;
- ``pack_bits``: the ``native.pack_bits`` calls that one
  ``ops.pack.pack_virtual_segments`` call of the ``N`` copies makes,
  replayed with its arguments;
- ``pack_virtual_segments``: the whole packer of the ``N`` copies (the
  walk, the lane bookkeeping and ``pack_bits``).

Before it is timed, every stream's result of every walker is checked equal
to a single-stream ``native.index_scan`` of the frame. Then
``csrc/host/bench_walk.cpp``, built by g++ against this package's host
library (``runtime.build``), times ``rjt_index_scan8/16/32`` on the frame
without Python; its width, height, components, lanes and symbols must be
``rjt_parse``'s and ``index_scan``'s.

Writes the record ``WALK_TORCH_r<N>.json`` (the next free N at the
checkout's root; ``WALK_OUT`` names another path) with the
host (CPU model, usable cores) and the card of the machine (``--device``;
the walk itself runs on the host), and prints it as one JSON line. A check
that fails makes the tool exit 1 and write nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from .. import api
from ..core.bitstream import JpegStreamParser
from ..ops import pack, staging
from ..ops.tables import DeviceScanTables, GroupGeometry
from ..runtime import build as host_build
from ..runtime import native
from . import bench, common

OUT_ENV = "WALK_OUT"
BENCH_WALK_SOURCE = os.path.join(os.path.dirname(host_build.SOURCE),
                                 "bench_walk.cpp")
BENCH_WALK_FLAGS = ["-O3", "-std=c++17"]
WALKERS = {8: native.index_scan8, 16: native.index_scan16,
           32: native.index_scan32}


class WalkError(RuntimeError):
    """A walker's records differ from the single-stream walk's, or
    ``bench_walk`` failed or disagreed with the Python walk."""


def settings() -> dict:
    return {"n": int(os.environ.get("N", "16")),
            "reps": int(os.environ.get("REPS", "5")),
            "vsyms": int(os.environ.get("VSYMS", str(api.VIRTUAL_SYMBOLS)))}


def dri0_frame() -> bytes:
    """The first frame of the bench's dri0 corpus."""
    s = bench.settings("dri0")
    return bench.leg_corpus("dri0", s["batch"], s["w"], s["h"],
                            s["ri_mcus"])[0][0]


def walk_frame() -> tuple:
    """The frame the tool walks and what it is, for the record: the
    bench's mug image, or dri0's first frame where it is absent."""
    if bench.mug_present():
        return bench.mug_image(), f"the bench's mug image, {bench.MUG_PATH}"
    return dri0_frame(), ("the first frame of the bench's dri0 leg "
                          "(tools/bench.py leg_corpus), standing in for the "
                          "root's mug image, which is not in the repository")


def _best_ms(fn, reps: int) -> float:
    fn()  # warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def _entry(ms: float, images: int, scan_bytes: int, **extra) -> dict:
    return dict(best_ms=ms, ms_per_img=ms / images, images=images,
                mb_s=scan_bytes * images / ms / 1e3, **extra)


def clean_span(bufs) -> int:
    """Bytes from the lowest start to the highest end of the clean-stream
    buffers of a walk's buffer sets."""
    return (max(b[0].ctypes.data + b[0].nbytes for b in bufs)
            - min(b[0].ctypes.data for b in bufs))


def slab_sets(n: int, clean_bytes: int, n_rec: int) -> list:
    """``n`` walk buffer sets (as ``staging.IdxBufPool`` hands them out)
    whose clean streams lie side by side in one allocation."""
    slab = np.empty(n * clean_bytes, np.uint8)
    return [(slab[i * clean_bytes:(i + 1) * clean_bytes],
             np.empty(n_rec, np.int64), np.empty((n_rec, 3), np.int32),
             np.empty(n_rec, np.int32), np.empty(n_rec, np.int32))
            for i in range(n)]


def check_scans(got, want) -> None:
    """Every stream's (clean, bit_off, dc, mcu_idx, sym_count) equal to
    the single-stream walk's."""
    for k, scan in enumerate(got):
        if len(scan) != len(want) or not all(
                np.array_equal(a, b) for a, b in zip(scan, want)):
            raise WalkError(f"stream {k}'s records differ from the "
                            "single-stream index_scan's")


@contextlib.contextmanager
def _pack_bits_calls():
    """Record the arguments of every ``native.pack_bits`` call made inside
    the block (each array copied), and still make the calls."""
    calls, real = [], native.pack_bits

    def record(*args):
        calls.append(tuple(np.array(a) for a in args))
        return real(*args)

    native.pack_bits = record
    try:
        yield calls
    finally:
        native.pack_bits = real


def bench_walk_command(out: str, lib: str) -> list:
    """The g++ command that builds ``bench_walk`` into ``out``, linked
    against the host library ``lib`` (found at run time by its rpath)."""
    return [host_build._gxx(), *BENCH_WALK_FLAGS, BENCH_WALK_SOURCE, lib,
            f"-Wl,-rpath,{os.path.dirname(lib)}", "-o", out]


def bench_walk_binary() -> str:
    """``bench_walk`` built by g++ against the package's host library, in
    ``kernels.build.build_dir()`` under a name hashed from its source, the
    flags and the library; built once."""
    lib = host_build.build()
    h = hashlib.sha256(" ".join(BENCH_WALK_FLAGS + [lib]).encode())
    with open(BENCH_WALK_SOURCE, "rb") as f:
        h.update(f.read())
    out = os.path.join(os.path.dirname(lib), f"bench_walk_{h.hexdigest()[:16]}")
    if not os.path.exists(out):
        tmp = f"{out}.tmp{os.getpid()}"
        host_build._run(bench_walk_command(tmp, lib))
        os.replace(tmp, out)
    return out


def run_bench_walk(blob: bytes, reps: int, vsyms: int) -> dict:
    """``bench_walk`` on ``blob`` (written to a temporary file): its
    lines as {name: {key: value}}. Raises WalkError when it exits
    non-zero."""
    exe = bench_walk_binary()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "frame.jpg")
        with open(path, "wb") as f:
            f.write(blob)
        proc = subprocess.run([exe, path, str(reps), str(vsyms)],
                              capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise WalkError(f"bench_walk exited {proc.returncode}:\n"
                        f"{proc.stdout}{proc.stderr}")
    out = {}
    for line in proc.stdout.splitlines():
        name, *pairs = line.split()
        out[name] = {k: (float(v) if "." in v else int(v))
                     for k, v in (p.split("=", 1) for p in pairs)}
    return out


def check_bench_walk(lines: dict, blob: bytes, want) -> None:
    """bench_walk's header and counts against the port's ``rjt_parse``
    (``native.parse_header``) and the single-stream walk."""
    hdr = lines["hdr"]
    params = native.parse_header(blob)
    if (hdr["width"], hdr["height"], hdr["components"]) != (
            params.picture_width, params.picture_height,
            params.num_components):
        raise WalkError(f"bench_walk read the header as {hdr}")
    for name, got in lines.items():
        if name == "hdr":
            continue
        if (got["recs_per_img"], got["syms_per_img"]) != (
                len(want[1]), int(want[4].sum())):
            raise WalkError(f"bench_walk {name}: {got['recs_per_img']} "
                            f"lanes and {got['syms_per_img']} symbols, the "
                            f"Python walk {len(want[1])} and "
                            f"{int(want[4].sum())}")


def profile() -> dict:
    """Every stage; returns the record's measurements."""
    cfg = settings()
    n, reps, S = cfg["n"], cfg["reps"], cfg["vsyms"]
    blob, corpus = walk_frame()
    plist = [JpegStreamParser().parse(blob) for _ in range(n)]
    p0 = plist[0]
    scan_bytes = len(p0.slice_data)
    want = native.index_scan(p0, S)
    bench._log(f"[walk] {n} copies of a {p0.picture_width}x"
               f"{p0.picture_height} DRI=0 frame, {scan_bytes / 1e6:.3f} MB "
               f"of scan, {len(want[1])} virtual lanes of >= {S} symbols")
    stages = {}
    stages["unstuff"] = _entry(
        _best_ms(lambda: native.unstuff(p0.slice_data), reps), 1, scan_bytes)
    pool = staging.walk_buffer_pool()
    caps = native.index_job_capacities(p0, S)
    avx512 = native.index_scan16_available()
    for width, walker in WALKERS.items():
        if width > n or (width > 8 and not avx512):
            continue
        token, bufs = pool.acquire(width, *caps)
        span = clean_span(bufs)
        got = walker(plist[:width], S, bufs)
        if got is None:
            # The walker refused the pooled sets, as it refuses them on
            # the main path, which then walks the chunk in halves.
            stages[f"index_scan{width}"] = {"refused": True,
                                            "images": width,
                                            "clean_span_bytes": span}
        else:
            check_scans(got, want)
            stages[f"index_scan{width}"] = _entry(_best_ms(
                lambda: walker(plist[:width], S, bufs), reps), width,
                scan_bytes, clean_span_bytes=span)
        pool.release(token)
        if width > 8:
            # The AVX-512 walkers address every clean stream by a 32-bit
            # offset from the lowest: here all of them in one allocation.
            slab = slab_sets(width, *caps)
            got = walker(plist[:width], S, slab)
            if got is None:
                raise WalkError(f"index_scan{width} refused streams in one "
                                "allocation")
            check_scans(got, want)
            stages[f"index_scan{width} one slab"] = _entry(_best_ms(
                lambda: walker(plist[:width], S, slab), reps), width,
                scan_bytes, clean_span_bytes=clean_span(slab))
    chunks = [plist[i:i + 8] for i in range(0, n - n % 8, 8)]
    if len(chunks) > 1:
        sets = [pool.acquire(8, *caps) for _ in chunks]
        jobs = list(zip(chunks, (b for _t, b in sets)))

        def split():
            return list(staging.pack_pool().map(
                lambda job: native.index_scan8(job[0], S, job[1]), jobs))
        for scans in split():
            check_scans(scans, want)
        stages["index_scan8 split"] = _entry(
            _best_ms(split, reps), 8 * len(chunks), scan_bytes,
            chunks=len(chunks))
        for token, _bufs in sets:
            pool.release(token)
    geom = GroupGeometry.from_params(p0, n)
    _tables, bank_of = DeviceScanTables.from_params_banked(plist)

    def pack_all():
        return pack.pack_virtual_segments(plist, geom.total_blocks, S,
                                          bank_of=bank_of)
    with _pack_bits_calls() as calls:
        pack_all()

    def replay():
        for args in calls:
            native.pack_bits(*args)
    stages["pack_bits"] = _entry(_best_ms(replay, reps), n, scan_bytes,
                                 calls=len(calls))
    stages["pack_virtual_segments"] = _entry(_best_ms(pack_all, reps), n,
                                             scan_bytes)
    for name, st in stages.items():
        if st.get("refused"):
            bench._log(f"[walk] {name:<24} refused the pooled buffer sets "
                       f"(their clean streams span "
                       f"{st['clean_span_bytes']} bytes)")
            continue
        bench._log(f"[walk] {name:<24}{st['best_ms']:>10.3f} ms "
                   f"{st['ms_per_img']:>9.3f} ms/img {st['mb_s']:>9.1f} MB/s")
    lines = run_bench_walk(blob, reps, S)
    check_bench_walk(lines, blob, want)
    for name, got in lines.items():
        bench._log(f"[bench_walk] {name} {got}")
    return {"copies": n, "reps": reps, "vsyms": S, "scan_bytes": scan_bytes,
            "width": p0.picture_width, "height": p0.picture_height,
            "lanes_per_img": len(want[1]),
            "symbols_per_img": int(want[4].sum()),
            "avx512": bool(avx512), "stages": stages, "bench_walk": lines,
            "bench_walk_equal": True, "corpus": corpus}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-d", "--device", type=common._device_arg, default=0,
                    help="the card the record names (default 0), or 'cpu'; "
                         "the walk runs on the host either way")
    args = ap.parse_args(argv)
    out = os.environ.get(OUT_ENV) or bench.next_record("WALK_TORCH")
    try:
        device = bench.resolve_device(args.device)
        record = profile()
    except (bench.BenchError, WalkError) as exc:
        print(f"profile_walk FAILED: {exc}", file=sys.stderr)
        return 1
    record.update(metric="host index walk: best of the reps, ms and MB/s "
                         "of scan bytes",
                  device=bench.device_info(device), host=bench.host_info())
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    bench._log(f"[walk] wrote {out}")
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
