"""One run of one cell: set-up, the window, the check, the result line.

Set-up makes the corpus from the seed on worker processes while the
process imports torch, finds the card and builds or loads the program's
libraries (they are cached in ``build/`` of the checkout), makes one
``rocjpeg_tpu_torch.api.Decoder`` and warms exactly the cell's shapes:
each batch of the rotation once, then every client twice at once. The
window follows (``harness.window``); with ``trace`` its first
:data:`TRACE_SECONDS` run under the profiler (``harness.trace``). Then the
peak device memory is read, the kept outputs are checked
(``harness.check``), and the metrics the cell reports are read by their
readers (``metrics/<name>.py``).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import random
import sys
import time

from . import check, corpus, pool, roofline, spec, subject, window

TRACE_SECONDS = 10.0
WARM_CALLS = 2
# Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "rocjpeg_tpu")


class NoDevice(RuntimeError):
    """The cell's cards are not there."""


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    cell: spec.Cell
    setup_s: float
    window: window.Window
    launches: int             # K1 launches in the window
    bytes_per_call: dict      # harness.roofline.per_call
    peak_bytes_per_s: float
    trace: object = None      # harness.trace.Trace of a traced run


def process_start() -> float:
    """The wall-clock time this process started."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def cache_dirs(root: str) -> None:
    """Fixed cache directories inside the checkout for every compiler the
    program may use (its own libraries go to ``build/`` already)."""
    build = os.path.join(root, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def keep_times(seed: int, seconds: float, n: int) -> list:
    """When (seconds into the window) the calls that keep their outputs
    start: drawn from the seed, within the first nine tenths."""
    rng = random.Random(int(seed) * 7919 + 1)
    return sorted(rng.uniform(0, 0.9 * seconds) for _ in range(n))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda:0", make_subject=None, t_start=None) -> dict:
    """One run; returns the result line. ``device`` "cpu" and
    ``make_subject`` (subject factory, for the control and for tests) skip
    the look for a card."""
    t_start = process_start() if t_start is None else t_start
    cache_dirs(spec.ROOT)
    fmt = cell.mix["format"]
    clients = int(cell.mix["clients"])
    subj, batches = _setup(cell, seed, device, make_subject, t_start)
    import torch
    from torch.profiler import record_function

    from rocjpeg_tpu_torch.kernels import build as kbuild
    from rocjpeg_tpu_torch.kernels import wave

    from . import trace as tracing
    prof = tracing.profiler() if trace else None

    def during(t0):
        with record_function(tracing.SLICE):
            time.sleep(max(0.0, min(TRACE_SECONDS, seconds)
                           - (time.perf_counter() - t0)))
        prof.stop()

    with kbuild.count_lock:
        launches0 = wave.launches
    setup_s = time.time() - t_start
    if prof is not None:
        prof.start()
    win = window.run(subj, batches, clients, seconds,
                     keep_at=keep_times(seed, seconds,
                                        int(cell.config["check_calls"])),
                     record_function=record_function,
                     during=during if prof is not None else None)
    if subj.cuda:
        torch.cuda.synchronize()
    with kbuild.count_lock:
        launches = wave.launches - launches0
    _log_window(win, seconds, launches)
    peak = torch.cuda.max_memory_allocated() if subj.cuda else 0
    name = torch.cuda.get_device_name(0) if subj.cuda else "cpu"

    traced = None
    if prof is not None:
        t_red = time.time()
        traced = tracing.reduce(prof.events())
        del prof
        log(f"[trace] slice of {traced.seconds:.3f} s reduced in "
            f"{time.time() - t_red:.3f} s")

    # The check runs once the peak is read and the program's state is
    # freed: only the kept outputs, brought to the host, outlive it.
    bad = [c for c in win.calls
           if c.error is not None or subj.flagged(c.flags or [])]
    outputs = check.kept_outputs(win, subj)
    for c in win.calls:
        c.flags = None
    del subj
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    t_check = time.time()
    with pool.pool() as workers:
        nums = check.numbers(workers, cell.bench_dir, cell.config, seed, fmt,
                             outputs, len(bad))
    correct, checks = check.verdict(nums)
    log(f"[check] {nums['images_checked']} images against the reference in "
        f"{time.time() - t_check:.3f} s")

    r = Run(cell, setup_s, win, launches,
            roofline.per_call(batches, fmt, cell.config["subsampling"]),
            roofline.peak_bytes_per_s(name), traced)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(cell.bench_dir, m["name"])(r)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if name != "cpu" else "cpu", "kind": name,
           "count": cell.chips, "memory_peak_bytes": peak}
    line = {"correct": correct,
            "attempted": sum(len(c.batch.images) for c in win.calls),
            "failed": sum(len(c.batch.images) for c in bad)
            + nums["images_wrong"],
            "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"] = traced.busy_us / 1e6
        dev["window_s"] = traced.seconds
        line["breakdown"] = tracing.breakdown(traced)
    line["checks"] = checks
    return line


def _setup(cell, seed, device, make_subject, t_start) -> tuple:
    """The subject and the corpus, warmed: the corpus is encoded on worker
    processes while this process imports torch and makes the decoder."""
    def mark(what):
        log(f"[setup] {what} at {time.time() - t_start:.3f} s")

    mark("process up")
    fmt = cell.mix["format"]
    with pool.pool() as workers:
        batches, pending = corpus.start(cell.config, cell.mix, seed, workers)
        import torch
        mark("torch imported")
        if device.startswith("cuda"):
            if not torch.cuda.is_available() or \
                    torch.cuda.device_count() < cell.chips:
                raise NoDevice(
                    f"the cell needs {cell.chips} CUDA device(s); "
                    f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                    f"device_count={torch.cuda.device_count()}")
            torch.cuda.init()
        if make_subject is None:
            subj = subject.Port(device, fmt)
        else:
            subj = make_subject(cell, seed, device, fmt)
        mark("device and decoder ready")
        corpus.finish(batches, pending)
        mark("corpus encoded")
    log(f"[setup] corpus: {len(batches)} batches of {len(batches[0].images)} "
        f"images, {batches[0].pixels / 1e6:.4f} Mpix a call, "
        f"{corpus.bits_per_pixel(batches):.4f} bits per pixel")
    _warm(subj, batches, int(cell.mix["clients"]))
    if subj.cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    mark("warmed up")
    return subj, batches


def _log_window(win, seconds, launches) -> None:
    done = win.completed()
    if done:
        parse = sum(c.parsed - c.start for c in done) / len(done) * 1e3
        rest = sum(c.end - c.parsed for c in done) / len(done) * 1e3
        log(f"[window] {len(win.calls)} calls started, {len(done)} completed "
            f"in {seconds} s; a call: parse {parse:.3f} ms, decode and "
            f"wait {rest:.3f} ms; K1 launches {launches}")


def _warm(subj, batches: list, clients: int) -> None:
    """Each batch of the rotation once, then :data:`WARM_CALLS` calls a
    client with every client at once, as in the window."""
    for b in batches:
        subj.decode(b, subj.parse(b))
        subj.wait()
    win = window.run(subj, batches, clients, float("inf"),
                     max_calls=WARM_CALLS * clients)
    bad = [c.error for c in win.calls if c.error is not None]
    if bad:
        raise RuntimeError(f"a warm-up call failed:\n{bad[0]}")


def _stop_resource_tracker() -> None:
    """End the helper process the worker pools started, and wait for it,
    so the run leaves no process behind."""
    from multiprocessing import resource_tracker
    gc.collect()  # the pools' semaphores go first, unregistered
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()


def main(argv=None) -> int:
    import argparse
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--clients", type=int,
                    help="override the mix's client count (pilots)")
    a = ap.parse_args(argv)
    try:
        cell = spec.cell(a.workload)
        if a.clients:
            cell.mix["clients"] = a.clients
        line = run(cell, a.seed, a.seconds, bool(a.trace), t_start=t_start)
    except NoDevice as exc:
        log(f"[bench] no result: {exc}")
        return 2
    _stop_resource_tracker()
    found = forbidden_modules()
    if found:
        log(f"[bench] no result: modules loaded that the run may not load: "
            f"{found}")
        return 3
    for text in check.describe(line["checks"]):
        log(text)
    print(json.dumps(line), flush=True)
    return 0
