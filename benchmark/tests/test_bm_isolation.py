"""What a run loads, and what it does without a card or without the
program."""

import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, make_root

PROBE = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
from harness import runner, spec
line = runner.run(spec.cell("tiny.rgb", {troot!r}), 3, 0.5, False,
                  device="cpu")
print(json.dumps({{"correct": line["correct"],
                   "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    troot = make_root(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(bench=str(troot / "benchmark"),
                                            root=ROOT, troot=str(troot))],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert "rocjpeg_tpu_torch" in res["top"]
    for name in ("jax", "jaxlib", "flax", "rocjpeg_tpu"):
        assert name not in res["top"]


def test_the_reference_loads_nothing_of_the_program():
    cfg_path = os.path.join(BENCH, "configs", "imagenet.json")
    code = (f"import sys; sys.path.insert(0, {BENCH!r});"
            "from harness import spec, check;"
            "import json;"
            f"cfg = json.load(open({cfg_path!r}));"
            f"ref = spec.reference({BENCH!r}, cfg);"
            "ref.decode(cfg, 1, 0, 0, 96, 64, 'rgb');"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    top = out.stdout
    for name in ("rocjpeg_tpu_torch", "rocjpeg_tpu", "jax", "torch"):
        assert f"'{name}'" not in top


def test_without_a_card_the_run_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "imagenet.rgb", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_the_run_fails(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark."""
    troot = make_root(tmp_path)
    code = (f"import sys; sys.path[:0] = [{str(troot / 'benchmark')!r}, "
            f"{str(troot)!r}];"
            "from harness import runner, spec;"
            f"runner.run(spec.cell('tiny.rgb', {str(troot)!r}), 1, 0.5, "
            "False, device='cpu')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(troot))
    assert out.returncode != 0
    assert "rocjpeg_tpu_torch" in out.stderr


@pytest.mark.card
@pytest.mark.parametrize("workload", ["uhd420.dri0", "imagenet.rgb"])
def test_each_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         workload, "--seed", "7", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
