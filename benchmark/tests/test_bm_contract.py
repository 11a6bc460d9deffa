"""BENCHMARK.json and the result line keep to the benchmark's contract."""

import json
import os
import re

import pytest

from conftest import ROOT, make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device",
             "checks"}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_names_units_and_bounds():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
    assert 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, "benchmark", "mixes",
                                           w["traffic"] + ".json"))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert e2e == {"mpix_s", "call_ms_p95", "setup_s"}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics",
                                           m["name"] + ".py"))
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m["workloads"]) <= cells


@pytest.mark.parametrize("mix", ["dri0", "rgb"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys_and_correct(tmp_path, mix, trace):
    """A tiny cell on the CPU: the line's keys, its names and units, and
    a correct decode."""
    from harness import runner, spec
    cell = spec.cell(f"tiny.{mix}", str(make_root(tmp_path)))
    line = runner.run(cell, 2 ** 33 + 17, 1.0, bool(trace), device="cpu")
    keys = LINE_KEYS | ({"breakdown"} if trace else set())
    assert set(line) == keys and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    want = cell.per_layer if trace else cell.end_to_end
    for name, m in line["metrics"].items():
        assert NAME.match(name) and UNIT.match(m["unit"])
        assert name in {x["name"] for x in want}
    if not trace:
        assert set(line["metrics"]) == {"mpix_s", "call_ms_p95", "setup_s"}
    else:
        assert "parse.ms_per_call" in line["metrics"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
