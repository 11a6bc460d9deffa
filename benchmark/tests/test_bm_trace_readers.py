"""The readers of the program's own spans (``parse.stream_ms_per_call``,
``api.self_ms_per_call``, ``api.throttle_ms_per_call``,
``staging.wait_ms_per_call``) on a trace reduced from synthetic profiler
events, and in a traced run of a tiny cell on the CPU."""

import types

import pytest
from torch.autograd import DeviceType

from conftest import BENCH, make_root

NEW = ("parse.stream_ms_per_call", "api.self_ms_per_call",
       "api.throttle_ms_per_call", "staging.wait_ms_per_call")


def _event(name, thread, start, end):
    return types.SimpleNamespace(
        name=name, thread=thread, device_type=DeviceType.CPU,
        time_range=types.SimpleNamespace(start=start, end=end))


def _run(spans):
    """A run whose trace is reduced from a slice of 0-10,000 us on thread
    0 and ``spans`` ((name, start, end), us) on thread 1."""
    from harness import runner, trace
    events = [_event("bench.slice", 0, 0.0, 10_000.0)]
    events += [_event(n, 1, s, e) for n, s, e in spans]
    return runner.Run(None, 0.0, None, 0, {}, 0.0, trace.reduce(events))


def _read(name, run):
    from harness import spec
    return spec.reader(BENCH, name)(run)


# Two calls: the first waits in the throttle and for a staging buffer,
# the second waits for nothing.
WAITED = [
    ("bench.call", 100, 1100), ("bench.parse", 100, 200),
    ("rjt.parse", 110, 140), ("rjt.parse", 150, 190),
    ("rjt.decode", 200, 1000),
    ("rjt.throttle", 210, 310),
    ("rjt.pack", 320, 620), ("rjt.walk", 330, 530),
    ("rjt.stage_wait", 540, 560),
    ("rjt.upload", 630, 650), ("rjt.wave", 650, 660),
    ("rjt.transform", 660, 670), ("rjt.epilogue", 670, 690),
    ("rjt.error_check", 700, 900),
]
QUIET = [
    ("bench.call", 2000, 2600), ("bench.parse", 2000, 2100),
    ("rjt.parse", 2010, 2050),
    ("rjt.decode", 2100, 2500),
    ("rjt.pack", 2110, 2210), ("rjt.upload", 2220, 2230),
    ("rjt.wave", 2230, 2240), ("rjt.transform", 2240, 2250),
    ("rjt.epilogue", 2250, 2260),
]


def test_readers_on_a_synthetic_trace():
    run = _run(WAITED + QUIET)
    assert run.trace.calls_inside == 2
    got = {name: _read(name, run) for name in NEW}
    assert got["parse.stream_ms_per_call"] == pytest.approx(
        (30 + 40 + 40) / 1e3 / 2)
    # rjt.decode less its direct children; rjt.walk and rjt.stage_wait
    # are inside rjt.pack and count once.
    first = 800 - (100 + 300 + 20 + 10 + 10 + 20 + 200)
    second = 400 - (100 + 10 + 10 + 10 + 10)
    assert got["api.self_ms_per_call"] == pytest.approx(
        (first + second) / 1e3 / 2)
    assert got["api.throttle_ms_per_call"] == pytest.approx(100 / 1e3 / 2)
    assert got["staging.wait_ms_per_call"] == pytest.approx(20 / 1e3 / 2)
    # The harness's own parse range still reads as before beside them.
    assert _read("parse.ms_per_call", run) == pytest.approx(200 / 1e3 / 2)


def test_host_entropy_is_a_direct_child_too():
    run = _run([("bench.call", 100, 1100), ("bench.parse", 100, 200),
                ("rjt.parse", 110, 190), ("rjt.decode", 200, 1000),
                ("rjt.host_entropy", 210, 610), ("rjt.upload", 620, 700),
                ("rjt.stage_wait", 630, 640), ("rjt.transform", 700, 720),
                ("rjt.epilogue", 720, 740)])
    assert _read("api.self_ms_per_call", run) == pytest.approx(
        (800 - (400 + 80 + 20 + 20)) / 1e3)
    assert _read("staging.wait_ms_per_call", run) == pytest.approx(0.01)


def test_a_wait_that_never_happened_reads_zero():
    run = _run(QUIET)
    assert _read("api.throttle_ms_per_call", run) == 0.0
    assert _read("staging.wait_ms_per_call", run) == 0.0


def test_without_the_program_spans_the_readers_read_nothing():
    """A program without the spans (the parent of the change that added
    them) has its stage ranges but no rjt.parse and no rjt.decode."""
    old = [s for s in WAITED + QUIET
           if s[0] not in ("rjt.parse", "rjt.decode", "rjt.throttle",
                           "rjt.stage_wait", "rjt.error_check")]
    run = _run(old)
    for name in NEW:
        assert _read(name, run) is None, name
    assert _read("pack.walk_ms_per_call", run) is not None
    from harness import runner
    untraced = runner.Run(None, 0.0, None, 0, {}, 0.0, None)
    for name in NEW:
        assert _read(name, untraced) is None, name


def test_a_traced_tiny_run_prints_the_new_metrics(tmp_path):
    from harness import runner, spec
    cell = spec.cell("tiny.dri0", str(make_root(tmp_path)))
    line = runner.run(cell, 2 ** 33 + 29, 1.0, True, device="cpu")
    assert line["correct"] is True
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(NEW) <= set(got)
    assert got["parse.stream_ms_per_call"] > 0
    assert got["api.self_ms_per_call"] > 0
    assert got["api.throttle_ms_per_call"] >= 0.0
    assert got["staging.wait_ms_per_call"] >= 0.0
    gaps = dict(line["breakdown"]["idle_gaps"])
    assert "rjt.decode" in gaps or "rjt.parse" in gaps
