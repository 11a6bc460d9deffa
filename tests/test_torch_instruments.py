"""The port's measurement instruments on the CPU, at a tiny size.

``tools/threads_sweep.py`` writes every leg x thread point, each from a
fresh process, with ``best`` its argmax, and fails when a leg's process
fails. ``tools/profile_stages.py`` gives every stage of each leg with its
ceiling (the leg's Mpix over the stage's ms), ``pack_total`` at least the
walk on dri0, and a model that follows from its stages; its
``device_limit`` chain (K1 -> K2 -> K3 on a staged group, here their plain
versions) gives the JAX package's ``Decoder`` output byte for byte.
``tools/profile_walk.py`` checks every walker's records against the
single-stream walk before it times them. Each tool reads the bench's mug
image (``bench.MUG_PATH``, here a small DRI=0 frame in a temporary file)
where it exists, as the root tools do, and the dri0 leg in its place where
it does not; its record says which.
"""

import json
import os

import numpy as np
import pytest
import torch

from rocjpeg_tpu import api as japi
from rocjpeg_tpu import types as jtypes
from rocjpeg_tpu_torch import api, pipeline
from rocjpeg_tpu_torch.core.bitstream import JpegStreamParser
from rocjpeg_tpu_torch.ops import pack
from rocjpeg_tpu_torch.runtime import native
from rocjpeg_tpu_torch.testing import encoder
from rocjpeg_tpu_torch.tools import (bench, profile_stages, profile_walk,
                                     threads_sweep)
from rocjpeg_tpu_torch.types import OutputFormat
from test_torch_jaxlib import jax_native  # noqa: F401  (autouse)

TINY = {"BENCH_W": "256", "BENCH_H": "128", "BENCH_BATCH": "2",
        "BENCH_ITERS": "2", "BENCH_REPS": "1", "OMP_NUM_THREADS": "1",
        "BENCH_ENTROPY": "on"}
TOOL_VARS = ("BENCH_LEG", "BENCH_THREADS", "BENCH_FMT", "BENCH_EXTRAS",
             "THREADS_LEGS", "THREADS_SET", "THREADS_OUT", "PROF_LEG",
             "PROF_REPS", "ROOFLINE_OUT", "N", "REPS", "VSYMS", "WALK_OUT")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("instrument_corpus"))


@pytest.fixture
def tiny(cache, monkeypatch):
    """The tools' knobs at the tiny size, the corpora in a private cache."""
    for k in TOOL_VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in TINY.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BENCH_CORPUS_CACHE", cache)


def _line(captured) -> dict:
    lines = captured.out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_sweep_writes_every_point_and_the_best(tiny, tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.setenv("THREADS_SET", "1,2")
    out = tmp_path / "threads.json"
    monkeypatch.setenv("THREADS_OUT", str(out))
    assert threads_sweep.main(["--device", "cpu"]) == 0
    rec = json.loads(out.read_text())
    assert rec == _line(capsys.readouterr())
    assert rec["device"] == "cpu" and rec["reps"] == 1
    assert set(rec["host"]) == {"cpu", "cpu_id", "isa", "usable_cores",
                                "cpu_count"}
    assert rec["host"]["usable_cores"] == len(os.sched_getaffinity(0))
    assert rec["torch_threads"] == [1]  # OMP_NUM_THREADS in each process
    paths = {"headline": ["wave"], "dri0": ["wave-virtual"]}
    assert set(rec["legs"]) == set(paths)
    for leg, got in rec["legs"].items():
        assert set(got["threads"]) == set(got["points"]) == {"1", "2"}
        assert got["best"] == int(max(got["threads"],
                                      key=got["threads"].get))
        for t, point in got["points"].items():
            assert point["threads"] == int(t)
            assert got["threads"][t] == point["mpix_s"] > 0
            assert point["reps_mpix_s"] == [point["mpix_s"]]
            assert point["paths"] == paths[leg]
            assert point["launches"] == dict.fromkeys(bench.KERNELS, 0)
            assert point["peak_mib"] is None


def test_sweep_fails_when_a_leg_fails(tiny, tmp_path, monkeypatch, capsys):
    """A point whose process exits non-zero (a decoder mode the session
    API refuses) fails the sweep: exit 1, no record, no line."""
    monkeypatch.setenv("THREADS_LEGS", "headline")
    monkeypatch.setenv("THREADS_SET", "1")
    monkeypatch.setenv("BENCH_ENTROPY", "sometimes")
    out = tmp_path / "threads.json"
    monkeypatch.setenv("THREADS_OUT", str(out))
    assert threads_sweep.main(["--device", "cpu"]) == 1
    captured = capsys.readouterr()
    assert captured.out == "" and not out.exists()
    assert "leg headline: its process exited" in captured.err


@pytest.mark.parametrize("tool", [threads_sweep, profile_stages,
                                  profile_walk],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_without_a_card_the_tool_fails(tool, tiny, tmp_path, monkeypatch,
                                       capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var in ("THREADS_OUT", "ROOFLINE_OUT", "WALK_OUT"):
        monkeypatch.setenv(var, str(tmp_path / "r.json"))
    assert tool.main([]) == 1
    captured = capsys.readouterr()
    assert captured.out == "" and "no CUDA card" in captured.err
    assert not (tmp_path / "r.json").exists()


def test_next_record_counts_from_the_highest(tmp_path):
    assert bench.next_record("ROOFLINE_TORCH", str(tmp_path)) == str(
        tmp_path / "ROOFLINE_TORCH_r01.json")
    for name in ("ROOFLINE_TORCH_r01.json", "ROOFLINE_TORCH_r07.json",
                 "ROOFLINE_r05.json", "ROOFLINE_TORCH_r2.txt"):
        (tmp_path / name).write_text("{}")
    assert bench.next_record("ROOFLINE_TORCH", str(tmp_path)) == str(
        tmp_path / "ROOFLINE_TORCH_r08.json")


def test_profile_stages_gives_every_stage_and_its_ceiling(
        tiny, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PROF_REPS", "1")
    out = tmp_path / "roofline.json"
    monkeypatch.setenv("ROOFLINE_OUT", str(out))
    assert profile_stages.main(["--device", "cpu"]) == 0
    rec = json.loads(out.read_text())
    assert rec == _line(capsys.readouterr())
    assert rec["device"] == "cpu" and set(rec["legs"]) == {"headline",
                                                           "dri0"}
    for leg, got in rec["legs"].items():
        assert (got["batch"], got["w"], got["h"], got["reps"]) == (
            2, 256, 128, 1)
        assert got["mpix_per_iter"] == 2 * 256 * 128 / 1e6
        assert tuple(got["stages"]) == profile_stages.STAGES[leg]
        assert got["device_limit_equal"] is True
        assert got["launches"] == dict.fromkeys(bench.KERNELS, 0)
        for name, st in got["stages"].items():
            assert st["ms"] > 0, (leg, name)
            assert st["ceiling_mpix_s"] == got["mpix_per_iter"] / st[
                "ms"] * 1e3
        assert got["stages"]["h2d"]["bytes"] > 0
        m = got["model"]
        host = (got["stages"]["pack_total"]["cpu_ms"]
                + got["stages"]["h2d"]["host_ms"]) / 2
        assert m["host_core_ms_per_img"] == host
        assert m["device_ms_per_img"] == got["stages"]["device_limit"][
            "ms"] / 2
        assert m["host_cores_for_device_limit"] == host / m[
            "device_ms_per_img"]
        assert m["device_limit_mpix_s"] == got["stages"]["device_limit"][
            "ceiling_mpix_s"]
    st = rec["legs"]["dri0"]["stages"]
    walked = dict.fromkeys(pack.WALK_COUNTS, 0)
    walked["index_scan2"] = 1  # 2 frames: one pair
    assert st["walk"]["walkers"] == walked
    assert rec["legs"]["dri0"]["call"]["walkers"] == walked
    assert rec["legs"]["headline"]["call"]["walkers"] == dict.fromkeys(
        pack.WALK_COUNTS, 0)
    assert st["pack_total"]["ms"] >= st["walk"]["ms"]
    assert st["pack_bits+bookkeep"]["ms"] == (st["pack_total"]["ms"]
                                              - st["walk"]["ms"])
    assert rec["legs"]["dri0"]["vsyms"] == api.VIRTUAL_SYMBOLS


@pytest.mark.parametrize("leg", profile_stages.LEGS)
def test_device_limit_chain_matches_the_jax_package(leg, tiny):
    s = bench.settings(leg)
    blobs = bench.leg_corpus(leg, 2, 256, 128, s["ri_mcus"])[0]
    plist = [JpegStreamParser().parse(b) for b in blobs]
    vk = api.VIRTUAL_SYMBOLS if leg == "dri0" else None
    g = pipeline.pack_group(plist, "cpu", None, vk)
    got = profile_stages.first_image_channels(g, plist)
    want = japi.Decoder(device_entropy="on").decode_batched(
        [japi.JpegStream(b) for b in blobs],
        jtypes.DecodeParams(jtypes.OutputFormat(int(OutputFormat.NATIVE))))[0]
    want = [np.asarray(c) for c in want.channel if c is not None]
    assert len(got) == len(want) == 2  # NV12: Y and interleaved UV
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_chain_check_refuses_a_differing_chain(tiny, monkeypatch):
    blobs = bench.leg_corpus("headline", 2, 256, 128, 4)[0]
    streams = [api.JpegStream(b) for b in blobs]
    plist = [s.params for s in streams]
    g = pipeline.pack_group(plist, "cpu")
    profile_stages.check_chain(streams, g, plist, torch.device("cpu"))
    real = profile_stages.first_image_channels

    def off_by_one(g, plist):
        chans = real(g, plist)
        chans[0][0, 0] ^= 1
        return chans

    monkeypatch.setattr(profile_stages, "first_image_channels", off_by_one)
    with pytest.raises(profile_stages.ProfileError):
        profile_stages.check_chain(streams, g, plist, torch.device("cpu"))


def test_profile_walk_checks_every_walker(tiny, tmp_path, monkeypatch,
                                         capsys):
    monkeypatch.setenv("REPS", "1")
    out = tmp_path / "walk.json"
    monkeypatch.setenv("WALK_OUT", str(out))
    assert profile_walk.main(["--device", "cpu"]) == 0
    rec = json.loads(out.read_text())
    assert rec == _line(capsys.readouterr())
    assert (rec["copies"], rec["vsyms"], rec["width"], rec["height"]) == (
        16, api.VIRTUAL_SYMBOLS, 256, 128)
    want = {"unstuff", "index_scan8", "index_scan8 split", "pack_bits",
            "pack_virtual_segments"}
    if native.index_scan16_available():
        want |= {"index_scan16", "index_scan16 one slab"}
    assert set(rec["stages"]) == want
    for name, st in rec["stages"].items():
        assert not st.get("refused"), name  # the pool's sets are one slab
        if name.startswith("index_scan"):
            assert 0 < st.get("clean_span_bytes", 1) < 1 << 32
        assert st["ms_per_img"] == st["best_ms"] / st["images"]
        assert st["mb_s"] == rec["scan_bytes"] * st["images"] / st[
            "best_ms"] / 1e3
    assert rec["stages"]["index_scan8 split"]["chunks"] == 2
    if native.index_scan16_available():
        assert rec["stages"]["index_scan16 one slab"]["clean_span_bytes"] \
            == 16 * native.index_job_capacities(
                JpegStreamParser().parse(profile_walk.dri0_frame()), 768)[0]
    assert rec["bench_walk_equal"] is True
    assert rec["bench_walk"]["hdr"]["width"] == 256


def test_walkers_equal_the_single_stream_walk(tiny):
    blob = profile_walk.dri0_frame()
    plist = [JpegStreamParser().parse(blob) for _ in range(32)]
    want = native.index_scan(plist[0], api.VIRTUAL_SYMBOLS)
    for width, walker in profile_walk.WALKERS.items():
        got = walker(plist[:width], api.VIRTUAL_SYMBOLS)
        if got is None:
            assert width > 8 and not native.index_scan16_available()
            continue
        assert len(got) == width
        profile_walk.check_scans(got, want)
    bad = [a.copy() for a in want]
    bad[1][-1] += 1
    with pytest.raises(profile_walk.WalkError):
        profile_walk.check_scans([want, tuple(bad)], want)


def test_wide_walkers_take_streams_in_one_slab(tiny):
    """The AVX-512 walkers on sets carved from one allocation give the
    single-stream walk's records, and refuse sets whose clean streams lie
    more than their 32-bit offsets apart."""
    if not native.index_scan16_available():
        pytest.skip("this host has no AVX-512")
    blob = profile_walk.dri0_frame()
    plist = [JpegStreamParser().parse(blob) for _ in range(16)]
    want = native.index_scan(plist[0], 768)
    caps = native.index_job_capacities(plist[0], 768)
    slab = profile_walk.slab_sets(16, *caps)
    assert profile_walk.clean_span(slab) == 16 * caps[0]
    profile_walk.check_scans(native.index_scan16(plist, 768, slab), want)
    far = np.empty(caps[0] + (1 << 32), np.uint8)  # reserved, not touched
    spread = list(slab)
    spread[-1] = (far[-caps[0]:],) + tuple(slab[-1][1:])
    assert profile_walk.clean_span(spread) > 1 << 32
    assert native.index_scan16(plist, 768, spread) is None


def test_unstuff_is_the_walkers_clean_stream(tiny):
    blob = profile_walk.dri0_frame()
    p = JpegStreamParser().parse(blob)
    clean = native.unstuff(p.slice_data)
    assert clean.tobytes() == native.index_scan(p, 768)[0].tobytes()
    assert clean.tobytes() == p.slice_data.replace(b"\xff\x00", b"\xff")


def _in_process(monkeypatch):
    """Run the tools' leg processes in this process, so that they see the
    monkeypatched ``bench.MUG_PATH``."""
    def bench_leg(leg, device, env=None):
        with monkeypatch.context() as m:
            for k, v in (env or {}).items():
                m.setenv(k, v)
            return bench.run_leg(leg, bench.resolve_device(device))

    monkeypatch.setattr(bench, "run_leg_process", bench_leg)
    monkeypatch.setattr(profile_stages, "run_leg_process",
                        lambda leg, device: profile_stages.run_leg(
                            leg, bench.resolve_device(device)))


MUG_FRAME = (96, 64)  # width, height of the test's stand-in image


def _corpus_legs(tool, rec):
    """The record's legs (the walk: the frame it walked), and its
    ``corpus``."""
    if tool is profile_walk:
        return (rec["width"], rec["height"]), rec["corpus"]
    return list(rec["legs"]), rec["corpus"]


@pytest.mark.parametrize("present", [True, False],
                         ids=["with_image", "without_image"])
@pytest.mark.parametrize("tool", [threads_sweep, profile_stages,
                                  profile_walk],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_tool_reads_the_mug_image_or_its_stand_in(tool, present, tiny,
                                                  tmp_path, monkeypatch,
                                                  capsys):
    path = tmp_path / "mug_420.jpg"
    if present:
        path.write_bytes(encoder.encode_planes(
            encoder.photo_planes("420", *MUG_FRAME, seed=7), "420",
            restart_interval=0))
    monkeypatch.setattr(bench, "MUG_PATH", str(path))
    _in_process(monkeypatch)
    for k, v in {"THREADS_SET": "1", "PROF_REPS": "1", "REPS": "1"}.items():
        monkeypatch.setenv(k, v)
    for var in ("THREADS_OUT", "ROOFLINE_OUT", "WALK_OUT"):
        monkeypatch.setenv(var, str(tmp_path / "r.json"))
    assert tool.main(["--device", "cpu"]) == 0
    rec = json.loads((tmp_path / "r.json").read_text())
    assert rec == _line(capsys.readouterr())
    legs, corpus = _corpus_legs(tool, rec)
    if present:
        assert str(path) in corpus and "stands in" not in corpus
        if tool is profile_walk:
            assert legs == MUG_FRAME
        else:
            assert legs == ["headline", "mug"]
            mug = rec["legs"]["mug"]
            got = mug if tool is profile_stages else mug["points"]["1"]
            assert (got.get("batch") or got["images"]) == 32
    else:
        assert str(path) not in corpus
        assert "stand" in corpus and "mug image" in corpus
        if tool is profile_walk:
            assert legs == (256, 128)  # the dri0 leg's first frame
        else:
            assert legs == ["headline", "dri0"]
    if tool is profile_stages:
        walked = "mug" if present else "dri0"
        got = rec["legs"][walked]
        assert tuple(got["stages"]) == profile_stages.STAGES[walked]
        assert got["device_limit_equal"] is True
        assert (got["w"], got["h"]) == (MUG_FRAME if present else (256, 128))
        # The N-core walk model: the walk is in the host side.
        assert got["stages"]["walk"]["cpu_ms"] <= got["stages"][
            "pack_total"]["cpu_ms"] * 1.5
        assert got["model"]["host_cores_for_device_limit"] > 0
