"""The port's profiler spans (``rocjpeg_tpu_torch.utils.trace``) on the CPU.

With no profiler a span never reaches ``record_function``. Under a
profiler built as the benchmark builds it (every thread, started with
``start()``), a CPU ``Decoder`` called from a second thread leaves its
spans on that thread, nested as ``utils.trace`` lists them: a
``rjt.parse`` a stream, the ``rjt.decode`` request span holding the
stages, and the waits (``rjt.throttle``, ``rjt.stage_wait``) only where a
wait happens. The sources open every range through ``span`` under a name
of ``SPANS``.
"""

import ast
import concurrent.futures
import importlib.util
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from rocjpeg_tpu_torch import api
from rocjpeg_tpu_torch.ops import staging
from rocjpeg_tpu_torch.testing import encoder
from rocjpeg_tpu_torch.types import DecodeParams, OutputFormat
from rocjpeg_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "rocjpeg_tpu_torch")
STAGES = ("rjt.pack", "rjt.upload", "rjt.wave", "rjt.transform",
          "rjt.epilogue")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """K1's plain version steps over small tensors: torch's intra-op pool
    only spins there, against the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blobs(n=2, restart=0):
    """``n`` 64x64 4:2:0 streams of flat planes: few symbols a lane keep
    K1's plain steps, each an operation the profiler records, few."""
    planes = [np.full((64, 64), 100, np.uint8),
              np.full((32, 32), 120, np.uint8),
              np.full((32, 32), 130, np.uint8)]
    return [encoder.encode_planes([p + k for p in planes], "420",
                                  restart_interval=restart)
            for k in range(n)]


def _bench_profiler():
    """The benchmark's profiler (``benchmark/harness/trace.py``)."""
    name = "bm_harness_trace"
    if name not in sys.modules:
        path = os.path.join(ROOT, "benchmark", "harness", "trace.py")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod  # its dataclass looks its module up
        spec.loader.exec_module(mod)
    return sys.modules[name].profiler()


def _traced(fn, during=None):
    """Run ``fn`` on a second thread under the benchmark's profiler
    (``during``, if given, runs on this thread meanwhile); returns the
    host spans of that thread whose names start with ``rjt.``, as
    (name, start, end) in start order."""
    from torch.autograd import DeviceType
    prof = _bench_profiler()
    prof.start()
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            fut = ex.submit(fn)
            if during is not None:
                during()
            fut.result(timeout=120)
    finally:
        prof.stop()
    by_thread = {}
    for ev in prof.events():
        if ev.name.startswith("rjt.") and ev.device_type == DeviceType.CPU:
            by_thread.setdefault(ev.thread, []).append(
                (ev.name, ev.time_range.start, ev.time_range.end))
    assert len(by_thread) <= 1, sorted(by_thread)  # the calling thread's
    return sorted((r for rs in by_thread.values() for r in rs),
                  key=lambda r: r[1])


def _inside(spans, inner, outer) -> bool:
    """Whether every ``inner`` span lies inside some ``outer`` span."""
    outs = [(s, e) for n, s, e in spans if n == outer]
    ins = [(s, e) for n, s, e in spans if n == inner]
    return bool(ins) and all(any(os_ <= s and e <= oe for os_, oe in outs)
                             for s, e in ins)


def _names(spans) -> set:
    return {n for n, _, _ in spans}


def test_no_profiler_no_record_function(monkeypatch):
    calls = []
    real = trace.record_function
    monkeypatch.setattr(trace, "record_function",
                        lambda name: calls.append(name) or real(name))
    blobs = _blobs()
    dec = api.Decoder(device="cpu", device_entropy="on")
    dec.decode_batched([api.JpegStream(b) for b in blobs])
    api.Decoder(device="cpu", device_entropy="off").decode_batched(
        [api.JpegStream(b) for b in blobs])
    assert calls == []
    with trace.span("rjt.decode") as got:
        assert got is None
    assert trace.span("rjt.parse") is trace.span("rjt.wave")
    # Under a profiler the same monkeypatch sees the spans.
    dec = api.Decoder(device="cpu", device_entropy="off")
    _traced(lambda: dec.decode_batched([api.JpegStream(b) for b in blobs]))
    assert set(calls) >= {"rjt.parse", "rjt.decode", "rjt.host_entropy",
                          "rjt.upload", "rjt.transform", "rjt.epilogue"}


def test_spans_of_a_call_from_a_second_thread():
    blobs = _blobs(3)  # one shape: one chunk
    dec = api.Decoder(device="cpu", device_entropy="on")
    dec.decode_batched([api.JpegStream(b) for b in blobs])  # warm

    def call():
        dec.decode_batched([api.JpegStream(b) for b in blobs],
                           DecodeParams(output_format=OutputFormat.RGB))

    spans = _traced(call)
    assert _names(spans) <= set(trace.SPANS)
    assert [n for n, _, _ in spans].count("rjt.parse") == len(blobs)
    assert [n for n, _, _ in spans].count("rjt.decode") == 1
    assert _inside(spans, "rjt.walk", "rjt.pack")  # DRI=0 input
    for name in STAGES + ("rjt.error_check",):
        assert _inside(spans, name, "rjt.decode"), name
    # Nothing waited: one chunk, a decoder alone with free slots and
    # buffers.
    assert not _names(spans) & {"rjt.throttle", "rjt.stage_wait",
                                "rjt.host_entropy"}


def test_restart_input_walks_nothing_and_unchecked_reads_no_flags():
    blobs = _blobs(2, restart=2)
    dec = api.Decoder(device="cpu", device_entropy="on", check_errors=False)
    spans = _traced(lambda: dec.decode_batched(
        [api.JpegStream(b) for b in blobs]))
    assert not _names(spans) & {"rjt.walk", "rjt.error_check"}
    for name in STAGES:
        assert _inside(spans, name, "rjt.decode"), name


def test_throttle_span_when_a_slot_is_waited_on():
    blobs = _blobs()
    streams = [api.JpegStream(b) for b in blobs]
    dec = api.Decoder(device="cpu", device_entropy="off")
    dec._max_inflight = 1
    dec._acquire_slot()  # held: the call finds every slot reserved

    def release():
        time.sleep(0.2)
        dec._release_slot()

    spans = _traced(lambda: dec.decode_batched(streams), during=release)
    assert _inside(spans, "rjt.throttle", "rjt.decode")
    waited = sum(e - s for n, s, e in spans if n == "rjt.throttle")
    assert waited > 50e3  # us: it waited for the release


class _StubEvent:
    """A copy's event that completes when the test sets it."""

    def __init__(self):
        self._done = threading.Event()

    def query(self):
        return self._done.is_set()

    def synchronize(self):
        assert self._done.wait(10), "stub event never set"

    def set(self):
        self._done.set()


@pytest.mark.parametrize("blocked_on", ["event", "buffer"])
def test_stage_wait_span_when_a_buffer_is_waited_on(blocked_on):
    """As ``test_torch_staging.py``'s forced waits: every buffer of the
    size is idle behind a pending copy (the oldest one's event), or out."""
    pool = staging.StagingPool(depth=1)
    a = pool.acquire(1000)
    ev = _StubEvent()
    if blocked_on == "event":
        pool.release(a, ev)

    def unblock():
        time.sleep(0.2)
        if blocked_on == "event":
            ev.set()
        else:
            pool.release(a, None)

    spans = _traced(lambda: pool.acquire(1000), during=unblock)
    assert _names(spans) == {"rjt.stage_wait"}
    assert sum(e - s for _, s, e in spans) > 50e3
    assert pool.stats()["waits"] == (blocked_on == "event")


def test_host_entropy_span_on_the_host_path():
    blobs = _blobs()
    dec = api.Decoder(device="cpu", device_entropy="off")
    spans = _traced(lambda: dec.decode_batched(
        [api.JpegStream(b) for b in blobs]))
    assert _inside(spans, "rjt.host_entropy", "rjt.decode")
    assert _inside(spans, "rjt.upload", "rjt.decode")
    assert not _names(spans) & {"rjt.pack", "rjt.walk", "rjt.wave",
                                "rjt.error_check"}


def test_tensor_decode_into_is_one_request_span():
    blobs = _blobs(1)
    stream = api.JpegStream(blobs[0])
    dec = api.Decoder(device="cpu", device_entropy="off")
    info = dec.get_image_info(stream)
    w, h = info.widths[0], info.heights[0]
    dest = api.DecodedImage.empty()
    dest.channel[0] = torch.zeros((h, 3 * w), dtype=torch.uint8)
    dest.pitch[0] = 3 * w
    params = DecodeParams(output_format=OutputFormat.RGB)
    spans = _traced(lambda: dec.decode_into(stream, dest, params))
    assert [n for n, _, _ in spans].count("rjt.decode") == 1
    assert _inside(spans, "rjt.epilogue", "rjt.decode")


def _sources():
    for base, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(base, f)
                with open(path) as fh:
                    yield os.path.relpath(path, ROOT), ast.parse(fh.read())


def test_every_range_goes_through_span_under_a_listed_name():
    used = set()
    for rel, tree in _sources():
        for node in ast.walk(tree):
            name = (node.id if isinstance(node, ast.Name) else node.attr
                    if isinstance(node, ast.Attribute) else
                    node.name if isinstance(node, ast.alias) else None)
            if name == "record_function":
                assert rel == os.path.join("rocjpeg_tpu_torch", "utils",
                                           "trace.py"), rel
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "span"):
                arg = node.args[0]
                assert isinstance(arg, ast.Constant), (rel, node.lineno)
                assert arg.value in trace.SPANS, (rel, arg.value)
                used.add(arg.value)
    assert used == set(trace.SPANS)


def test_the_flag_the_span_reads_follows_the_profiler():
    from torch.autograd import profiler
    assert profiler._is_profiler_enabled is False
    seen = []
    _traced(lambda: seen.append(profiler._is_profiler_enabled))
    assert seen == [True] and profiler._is_profiler_enabled is False
