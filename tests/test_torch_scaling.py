"""The port's scaling instrument, ``tools/scaling.py``, on the CPU.

Two gloo processes, each pinned to its own cores and decoding its own
frames of 256x128, through the three runs of a trial (solo, independent,
distributed): the record gives the three rates, and each efficiency is
exactly the ratio of those rates. Every worker's images are the JAX
package's ``Decoder`` output, digest for digest. A worker that fails fails
the tool; the layout puts ranks on cards or on one card as the card count
allows.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from rocjpeg_tpu import api as japi
from rocjpeg_tpu import types as jtypes
from rocjpeg_tpu_torch.tools import scaling
from test_torch_jaxlib import jax_native  # noqa: F401  (autouse)

TINY = {"BENCH_W": "256", "BENCH_H": "128", "SCALING_ITERS": "2",
        "SCALING_FRAMES": "2", "SCALING_TRIALS": "1", "OMP_NUM_THREADS": "1"}


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    for k in ("BENCH_RI_MCUS", "BENCH_BATCH", "SCALING_OUT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in TINY.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BENCH_CORPUS_CACHE", str(tmp_path / "corpus"))


def test_two_gloo_processes_give_the_three_rates(tiny, tmp_path, monkeypatch,
                                                capsys):
    out = tmp_path / "scaling.json"
    monkeypatch.setenv("SCALING_OUT", str(out))
    assert scaling.main(["--device", "cpu"]) == 0
    rec = json.loads(out.read_text())
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {k: v for k, v in rec.items() if k != "trials"}
    assert rec["device"] == "cpu"
    assert rec["layout"]["devices"] == ["cpu", "cpu"]
    assert rec["layout"]["backend"] == "gloo"
    a, b = rec["layout"]["cores"]
    assert a and b and not set(a) & set(b)
    (t,) = rec["trials"]
    solo, indep, dist = (t["1_proc_solo"], t["2_proc_independent"],
                         t["2_proc_distributed"])
    assert min(solo, indep, dist) > 0
    assert t["efficiency_layout"] == dist / indep
    assert t["efficiency_raw"] == dist / (2 * solo)
    assert t["contention_factor"] == indep / (2 * solo)
    assert t["dispatch_probe_ms_per_call"] > 0
    for key in ("efficiency_layout", "efficiency_raw", "contention_factor"):
        assert rec[f"{key}_all"] == [t[key]]
        assert rec[f"{key}_median"] == t[key]
    # The distributed rate is the reduced one: every image over the
    # longer process's seconds.
    workers = t["runs"]["distributed"]
    images, _mpix, secs = workers[0]["reduced"]
    assert images == sum(w["images"] for w in workers) == 2 * 2 * 2
    assert secs == max(w["seconds"] for w in workers)
    assert dist == images / secs
    assert indep == sum(w["rate"] for w in t["runs"]["independent"])
    assert [w["backend"] for w in workers] == ["gloo", "gloo"]

    # Each worker decoded its own frames, as the JAX package does.
    frames = scaling.corpus_frames(scaling.settings())
    jdec = japi.Decoder(device_entropy="on")
    params = jtypes.DecodeParams(jtypes.OutputFormat.NATIVE)
    want = []
    for blob in frames:
        img = jdec.decode_batched([japi.JpegStream(blob)], params)[0]
        want.append(hashlib.sha256(b"".join(
            np.ascontiguousarray(np.asarray(c)).tobytes()
            for c in img.channel if c is not None)).hexdigest())
    for run, results in t["runs"].items():
        assert [w["rank"] for w in results] == list(range(len(results)))
        for w in results:
            lo, hi = w["frames"]
            assert hi - lo == 2 and w["digests"] == want[lo:hi], run
            assert w["cores"] == rec["layout"]["cores"][w["rank"]]
            assert w["torch_threads"] == 1


def test_a_failing_worker_fails_the_tool(tiny, tmp_path, monkeypatch,
                                         capsys):
    """Frames narrower than the spec's 64-pixel minimum: every worker's
    decoder refuses them, and the tool exits 1 with no record."""
    monkeypatch.setenv("BENCH_W", "48")
    out = tmp_path / "scaling.json"
    monkeypatch.setenv("SCALING_OUT", str(out))
    assert scaling.main(["--device", "cpu"]) == 1
    captured = capsys.readouterr()
    assert captured.out == "" and not out.exists()
    assert "scaling FAILED: a worker exited" in captured.err


def test_efficiencies_are_the_rates_ratios(monkeypatch):
    rates = iter([10.0, 17.0, 16.0, 9.0, 18.0, 18.5, 11.0, 19.0, 17.5])

    def fake_run(nproc, distributed, cfg, devices, backend, cores):
        return {"rate": next(rates), "workers": [],
                "probe_ms": 0.25 if distributed else None}

    monkeypatch.setattr(scaling, "run", fake_run)
    monkeypatch.setattr(scaling, "corpus_frames", lambda cfg: [])
    monkeypatch.setenv("SCALING_TRIALS", "3")
    rec = scaling.measure("cpu")
    assert rec["efficiency_layout_all"] == [16 / 17, 18.5 / 18, 17.5 / 19]
    assert rec["efficiency_raw_all"] == [16 / 20, 18.5 / 18, 17.5 / 22]
    assert rec["contention_factor_all"] == [17 / 20, 18 / 18, 19 / 22]
    assert rec["efficiency_layout_median"] == sorted(
        [16 / 17, 18.5 / 18, 17.5 / 19])[1]
    assert rec["dispatch_probe_ms_per_call_median"] == 0.25


def test_layout_follows_the_card_count(monkeypatch):
    assert scaling.layout(2, "cpu") == (["cpu", "cpu"], "gloo")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert scaling.layout(2, 0) == (["cuda:0", "cuda:0"], "gloo")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert scaling.layout(2, 0) == (["cuda:0", "cuda:1"], "nccl")
    assert scaling.layout(1, 0) == (["cuda:0"], "gloo")


def test_core_sets_are_disjoint_and_refuse_too_many(monkeypatch):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {3, 1, 2, 0, 5})
    assert scaling.core_sets(2) == [[0, 1], [2, 3]]
    assert scaling.core_sets(5) == [[0], [1], [2], [3], [5]]
    with pytest.raises(scaling.ScalingError):
        scaling.core_sets(6)
