"""The benchmark's data, found by name.

``BENCHMARK.json`` at the checkout's root names the cells; everything that
belongs to one configuration, traffic mix or metric sits in a file of its
own, found from the name alone, so a later change adds a cell or a metric
by adding files and entries:

- a configuration: the ``file`` its ``configs`` entry names (JSON), whose
  ``reference`` names its plain reference, ``references/<name>.py``;
- a traffic mix: ``mixes/<traffic>.json``;
- a metric, end-to-end or per-layer: ``metrics/<name>.py``, a module
  with ``read(run)`` that returns the number, or None where it finds
  nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with what it names."""
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list   # the metric entries this cell reports, untraced
    per_layer: list    # and traced
    bench_dir: str


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, root: str = ROOT) -> Cell:
    """The cell called ``workload`` of ``<root>/BENCHMARK.json``; raises
    KeyError for a name it does not hold."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    w = {x["name"]: x for x in bench["workloads"]}[workload]
    c = {x["name"]: x for x in bench["configs"]}[w["config"]]
    bench_dir = os.path.join(root, bench["paths"][0])
    config = load_json(os.path.join(root, c["file"]))
    mix = load_json(os.path.join(bench_dir, "mixes", w["traffic"] + ".json"))
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, mix=mix,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        bench_dir=bench_dir)


def load_module(path: str, name: str):
    """A module from a file, under a name of the benchmark's own."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(bench_dir: str, metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return load_module(os.path.join(bench_dir, "metrics", metric + ".py"),
                       "bm_metric_" + metric.replace(".", "_")).read


def reference(bench_dir: str, config: dict):
    """The plain reference module a configuration names."""
    name = config["reference"]
    return load_module(os.path.join(bench_dir, "references", name + ".py"),
                       "bm_reference_" + name)
