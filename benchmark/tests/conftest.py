"""Tests of the benchmark (run them with ``python -m pytest
benchmark/tests``). Tests that need a CUDA card carry the ``card`` marker
and skip, with the reason, where there is none."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

# A cell small enough for the CPU: two shapes, one of odd size.
TINY = {"shapes": [[96, 64, 2], [75, 83, 1]], "rotation": 2,
        "check_calls": 2}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")


def make_root(tmp_path, extra=None):
    """A checkout holding the benchmark and BENCHMARK.json, with a tiny
    configuration ``tiny`` under each mix (cells ``tiny.<mix>``), as new
    files and entries; ``extra(root, bench)`` may add more."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(BENCH, "configs", "imagenet.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY, name="tiny")
    (root / "benchmark/configs/tiny.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny", "source": "https://example.org",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": ["shapes"], "why": "CPU tests"})
    for mix in ("dri0", "rgb"):
        bench["workloads"].append({"name": f"tiny.{mix}", "config": "tiny",
                                   "traffic": mix, "chips": 1,
                                   "why": "CPU tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m:
                m["workloads"].append(f"tiny.{mix}")
    if extra:
        extra(root, bench)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
