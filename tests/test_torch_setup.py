"""The toolchain check: it passes on the CPU when asked to, and without
``--device`` it checks for the card and fails on a machine without one,
naming what is missing and the command that would supply it. It never
checks the CPU instead."""

import json
import os
import subprocess
import sys

import pytest
import torch

from rocjpeg_tpu_torch.tools import setup_check

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args):
    proc = subprocess.run(
        [sys.executable, "-m", "rocjpeg_tpu_torch.tools.setup_check", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    return proc, json.loads(proc.stdout.strip().splitlines()[-1])


def test_cpu_check_passes():
    proc, res = _run("--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert res["ok"] and res["device"] == "cpu" and res["missing"] == []
    assert set(res["build_s"]) == {"host library", "C ABI"}
    assert "byte-equal to core.golden" in proc.stdout
    assert "MISSING" not in proc.stdout


def test_default_checks_the_card_and_fails_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default check passes")
    proc, res = _run()
    assert proc.returncode == 1
    assert res["ok"] is False and res["device"] == "cuda"
    assert {"card", "nvcc"} <= set(res["missing"])
    for key in res["missing"]:
        assert setup_check.FIXES[key] in proc.stdout
    assert "[MISSING] nvcc" in proc.stdout
    assert "[MISSING] CUDA device of compute capability 9.0" in proc.stdout
    assert "decoded" not in proc.stdout  # nothing ran on the CPU instead


def test_missing_compiler_is_reported(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("PATH", str(tmp_path))
    assert setup_check.check_toolchain("cpu") == ["g++"]
    out = capsys.readouterr().out
    assert "[MISSING] g++" in out and setup_check.FIXES["g++"] in out
