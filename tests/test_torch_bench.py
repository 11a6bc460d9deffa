"""The port's bench, ``rocjpeg_tpu_torch.tools.bench``, on the CPU.

Its legs build the root ``bench.py``'s corpora byte for byte; its mixed
leg's call (two shape groups, each on per-image Huffman tables) decodes
byte-equal to the JAX package's ``Decoder``; the tool runs every leg in a
process of its own with ``--device cpu`` and prints one line, and without
a card or that flag it fails. Its submitter threads share one ``Decoder``,
whose error flags are per thread: a flagged call on a worker thread must
fail the leg although the main thread's flags are clean.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from rocjpeg_tpu import api as japi
from rocjpeg_tpu import types as jtypes
from rocjpeg_tpu_torch import api, pipeline
from rocjpeg_tpu_torch.core.bitstream import JpegStreamParser
from rocjpeg_tpu_torch.status import RocJpegError, Status
from rocjpeg_tpu_torch.testing import encoder
from rocjpeg_tpu_torch.tools import bench
from rocjpeg_tpu_torch.types import DecodeParams, OutputFormat
from test_torch_jaxlib import jax_native  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench as root_bench  # noqa: E402  (the JAX package's bench)

F = OutputFormat


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain kernels step over small tensors: torch's intra-op pool
    only spins there, against the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """The port's corpus cache for the module: the 1920x1088 frames of the
    mixed leg are encoded once."""
    return str(tmp_path_factory.mktemp("torch_corpus"))


def _root_corpus(leg, n, w, h, ri):
    """The root bench's leg dispatch (``bench.py:421-460``)."""
    if leg in ("headline", "rgb"):
        return root_bench.build_corpus(n, w, h, ri_mcus=ri)
    if leg == "dri0":
        return root_bench.build_corpus(n, w, h, seed=1, ri_mcus=0)
    half = n // 2
    return (root_bench.build_corpus(half, w, h, seed=2, ri_mcus=ri,
                                    mixed_tables=True)
            + root_bench.build_corpus(half, 1920, 1088, seed=3, ri_mcus=ri,
                                      mixed_tables=True))


@pytest.mark.parametrize("leg", bench.LEGS)
def test_leg_corpus_is_the_root_benchs(leg, cache, tmp_path, monkeypatch):
    monkeypatch.setenv("BENCH_CORPUS_CACHE", cache)
    blobs, mpix, fmt = bench.leg_corpus(leg, 2, 64, 48, 4)
    monkeypatch.setenv("BENCH_CORPUS_CACHE", str(tmp_path / "root"))
    assert blobs == _root_corpus(leg, 2, 64, 48, 4)
    assert fmt == (F.RGB if leg == "rgb" else F.NATIVE)
    if leg == "mixed":
        assert mpix == (64 * 48 + 1920 * 1088) / 1e6
        assert [JpegStreamParser().parse(b).picture_width
                for b in blobs] == [64, 1920]
    else:
        assert mpix == 2 * 64 * 48 / 1e6
    assert bench.leg_corpus(leg, 2, 64, 48, 4, "rgb")[2] == F.RGB


def test_unknown_leg_is_refused():
    with pytest.raises(bench.BenchError, match="unknown leg 'mug'"):
        bench.leg_corpus("mug", 2, 64, 64, 4)


@pytest.fixture(scope="module")
def mixed(cache):
    """The mixed leg at 4 frames: 2 x 64x64 and 2 x 1920x1088, table
    variants 0 and 1 in each shape group."""
    old = os.environ.get("BENCH_CORPUS_CACHE")
    os.environ["BENCH_CORPUS_CACHE"] = cache
    try:
        return bench.leg_corpus("mixed", 4, 64, 64, 4)[0]
    finally:
        if old is None:
            del os.environ["BENCH_CORPUS_CACHE"]
        else:
            os.environ["BENCH_CORPUS_CACHE"] = old


def test_mixed_leg_groups_use_table_banks(mixed):
    plist = [JpegStreamParser().parse(b) for b in mixed]
    assert len({api.shape_key(p) for p in plist}) == 2
    for group in (plist[:2], plist[2:]):
        g = pipeline.pack_group(group, "cpu", None)
        assert g.lentab.shape[0] == 4 * 2  # one bank a table set


@pytest.mark.parametrize("fmt", [F.NATIVE, F.RGB], ids=lambda f: f.name)
def test_mixed_leg_call_matches_the_jax_package(mixed, fmt):
    jdec = japi.Decoder(device_entropy="on")
    tdec = api.Decoder(device="cpu", device_entropy="on")
    want = jdec.decode_batched([japi.JpegStream(b) for b in mixed],
                               jtypes.DecodeParams(jtypes.OutputFormat(
                                   int(fmt))))
    got = tdec.decode_batched([api.JpegStream(b) for b in mixed],
                              DecodeParams(fmt))
    # Each shape group takes the wave on two table banks, in both
    # packages.
    paths = [(p, list(i)) for p, i in tdec.last_paths]
    assert paths == [("wave", [0, 1]), ("wave", [2, 3])]
    assert paths == [(p, list(i)) for p, i in jdec.last_paths]
    for a, b in zip(want, got):
        for ci in range(4):
            if a.channel[ci] is None:
                assert b.channel[ci] is None
                continue
            assert a.pitch[ci] == b.pitch[ci]
            np.testing.assert_array_equal(np.asarray(a.channel[ci]),
                                          b.channel[ci].numpy())


def _env(cache, **extra):
    env = dict(os.environ, BENCH_CORPUS_CACHE=cache, BENCH_W="64",
               BENCH_H="64", BENCH_BATCH="2", BENCH_ITERS="2",
               BENCH_REPS="1", OMP_NUM_THREADS="1", **extra)
    env.pop("BENCH_LEG", None)
    return env


def test_cli_runs_every_leg_on_the_cpu(cache, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "rocjpeg_tpu_torch.tools.bench", "--device",
         "cpu", "--records", str(tmp_path)], cwd=ROOT,
        env=_env(cache, BENCH_ENTROPY="on"), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["metric"] == bench.METRIC and res["device"] == "cpu"
    assert res["unit"] == "Mpixel/s" and res["regressed"] is False
    assert set(res["legs"]) == set(bench.LEGS)
    want_paths = {"headline": ["wave"], "dri0": ["wave-virtual"],
                  "mixed": ["wave", "wave"], "rgb": ["wave"]}
    for leg, key in bench.LEG_KEYS.items():
        got = res["legs"][leg]
        assert res[key] == got["mpix_s"] > 0
        assert got["paths"] == want_paths[leg]
        assert got["format"] == ("RGB" if leg == "rgb" else "NATIVE")
        assert got["threads"] == (3 if leg == "dri0" else 4)
        assert (got["iters"], got["reps"], got["images"]) == (2, 1, 2)
        assert got["launches"] == {"wave": 0, "transform": 0,
                                   "epilogue": 0}  # plain versions
        assert got["peak_mib"] is None
    for leg in bench.LEGS:
        assert f"[{leg}] warm-up" in proc.stderr
    # The line is the next run's record: it gates a run of the same
    # device and no other.
    (tmp_path / "BENCH_TORCH_r01.json").write_text(lines[0])
    slower = dict(res, value=res["value"] * 0.5)
    assert bench.check_regressions(slower, records_dir=str(tmp_path))
    assert not bench.check_regressions(
        dict(slower, device={"name": "NVIDIA H100 80GB HBM3",
                             "power_limit": "700.00 W", "count": 1}),
        records_dir=str(tmp_path))


def test_without_a_card_the_tool_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("BENCH_LEG", raising=False)
    assert bench.main([]) == 1
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "no CUDA card" in captured.err and "--device cpu" in captured.err


def test_failed_leg_fails_the_tool(cache, monkeypatch, capsys):
    """A leg whose process exits non-zero (here: on an output format the
    tool does not know) is not dropped: no line, exit 1."""
    monkeypatch.setenv("BENCH_EXTRAS", "0")
    monkeypatch.setenv("BENCH_FMT", "no-such-format")
    for k, v in _env(cache).items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("BENCH_LEG", raising=False)
    assert bench.main(["--device", "cpu"]) == 1
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "leg headline: its process exited 1" in captured.err


def test_leg_past_its_timeout_fails_the_tool(cache, monkeypatch, capsys):
    for k, v in _env(cache).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BENCH_EXTRAS", "0")
    monkeypatch.delenv("BENCH_LEG", raising=False)
    monkeypatch.setattr(bench, "LEG_TIMEOUT_S", 0.01)
    assert bench.main(["--device", "cpu"]) == 1
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "no result within 0.01 s; its process was killed" in captured.err


def _corrupt(blob):
    """``blob`` with a run of 1 bits inside its first restart segment: no
    Huffman code is all ones, so the scan is flagged on the device while
    the headers still parse."""
    p = JpegStreamParser().parse(blob)
    sos = blob.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(blob[sos + 2:sos + 4], "big")
    rst = blob.index(b"\xff\xd0", start)
    assert rst - start > 12 and p.restart_interval
    return blob[:start + 2] + b"\xff\x00" * 4 + blob[start + 10:]


class _CorruptOffTheMainThread:
    """A decoder that decodes the given batch on the main thread (the
    warm-up) and, on every other thread, the batch with its first stream
    corrupt. Everything else is the wrapped decoder's, read in the calling
    thread."""

    def __init__(self, dec, bad):
        self._dec = dec
        self._bad = bad

    def decode_batched(self, streams, params=None):
        if threading.current_thread() is threading.main_thread():
            return self._dec.decode_batched(streams, params)
        return self._dec.decode_batched(self._bad, params)

    def __getattr__(self, name):
        return getattr(self._dec, name)


def test_flagged_call_on_a_worker_thread_fails_the_leg():
    blobs = [encoder.encode_planes(encoder.random_planes("420", 64, 64,
                                                         seed=s), "420",
                                   restart_interval=1) for s in range(2)]
    bad = [api.JpegStream(_corrupt(blobs[0])), api.JpegStream(blobs[1])]
    with pytest.raises(RocJpegError) as ei:  # the stream is flagged
        api.Decoder(device="cpu", device_entropy="on").decode_batched(bad)
    assert ei.value.status == Status.BAD_JPEG
    dec = _CorruptOffTheMainThread(
        api.Decoder(device="cpu", device_entropy="on", check_errors=False),
        bad)
    params = DecodeParams(F.NATIVE)
    with pytest.raises(bench.BenchError,
                       match=r"rep 1, thread \d, call 1: a decode error "
                             r"flagged on the device"):
        bench.run_config("trap", dec, blobs, params, iters=4, n_threads=4,
                         mpix_iter=0.008, reps=1)
    # The trap: the main thread's record is the clean warm-up's, so a
    # check of it alone after the threads join would have passed.
    assert not any(bool(e.any()) for e in dec.last_error_flags)
    # A clean batch on every thread passes, every call in flight checked.
    res = bench.run_config("clean", api.Decoder(
        device="cpu", device_entropy="on", check_errors=False), blobs,
        params, iters=4, n_threads=4, mpix_iter=0.008, reps=2)
    assert res["paths"] == ["wave"] and len(res["reps_mpix_s"]) == 2


def test_four_threads_on_one_decoder_decode_every_call_right():
    """Four submitter threads share one decoder, two calls each in flight:
    every call's bytes are the single-threaded decode's."""
    blobs = [encoder.encode_planes(encoder.random_planes("420", 64, 64,
                                                         seed=s), "420",
                                   restart_interval=1) for s in range(2)]
    streams = [api.JpegStream(b) for b in blobs]
    dec = api.Decoder(device="cpu", device_entropy="on")
    want = [img.channel[0].clone() for img in dec.decode_batched(
        streams, DecodeParams(F.RGB))]
    outs = [[] for _ in range(4)]

    def worker(tid):
        for _ in range(2):
            outs[tid].append(dec.decode_batched(streams, DecodeParams(F.RGB)))

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as it can
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    dec.synchronize()
    assert [len(o) for o in outs] == [2] * 4
    for calls in outs:
        for imgs in calls:
            for img, ref in zip(imgs, want):
                assert torch.equal(img.channel[0], ref)
