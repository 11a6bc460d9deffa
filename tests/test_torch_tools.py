"""The port's sample CLIs against the JAX package's, case by case.

Mirror of ``tests/test_tools.py``: the reference's 13 CTest cases
(jpeg-decode-fmt-* x5, jpeg-decode-threads-fmt-native,
jpeg-decode-batch-fmt-native, jpeg-decode-crop-fmt-* x5,
jpeg-decode-crop-batch-fmt-native) and the valid-crop case. Each case runs
the JAX tool and the port's (``-d cpu``) on the same seeded corpus, with
``-o`` into two directories, and asserts the same return code, the same
file names, byte-equal files (tolerance 0), and the same stdout once times
and directories are stripped. The corpus also holds a 4:1:1 stream, a
corrupt file and an image under 64x64, so every skip counter is compared.
"""

import os
import re

import pytest
import torch

from rocjpeg_tpu.tools import jpegdecode as jdecode
from rocjpeg_tpu.tools import jpegdecodebatched as jbatched
from rocjpeg_tpu.tools import jpegdecodeperf as jperf
from rocjpeg_tpu.utils import log as jlog
from rocjpeg_tpu_torch.testing import encoder
from rocjpeg_tpu_torch.tools import jpegdecode, jpegdecodebatched, jpegdecodeperf
from rocjpeg_tpu_torch.utils import log
from test_torch_jaxlib import jax_native  # noqa: F401  (autouse)

CROP = "960,540,2880,1620"  # the reference suite's: larger than the corpus
FORMATS = ["native", "yuv_planar", "y", "rgb", "rgb_planar"]
TOOLS = {"decode": (jdecode, jpegdecode),
         "batched": (jbatched, jpegdecodebatched),
         "perf": (jperf, jpegdecodeperf)}

# Lines that carry a time or a rate, and the part of a line that names the
# JAX package's host library (built or not, on the machine).
_TIMED = re.compile(r"average decoding time|avg images per sec|"
                    r"avg decoded data size")


def _write_corpus(d, tiny: bool):
    for i, css in enumerate(("420", "422", "400", "411")):
        blob = encoder.encode_planes(
            encoder.random_planes(css, 96, 64, seed=i), css,
            restart_interval=2)
        (d / f"img_{css}.jpg").write_bytes(blob)
    (d / "corrupt.jpg").write_bytes(b"\xff\xd8 not a jpeg")
    if tiny:
        blob = encoder.encode_planes(encoder.random_planes("420", 48, 32,
                                                           seed=7), "420")
        (d / "tiny.jpg").write_bytes(blob)
    return str(d)


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    return _write_corpus(tmp_path_factory.mktemp("corpus"), tiny=True)


@pytest.fixture(scope="module")
def perf_dir(tmp_path_factory):
    """The corpus without its image under 64x64: the JAX package's
    jpegdecodeperf skips no image by resolution, and its decode_batched
    raises JPEG_NOT_SUPPORTED for the whole batch."""
    return _write_corpus(tmp_path_factory.mktemp("perf"), tiny=False)


def _normalised(text, out_dir):
    lines = []
    for line in text.splitlines():
        if _TIMED.search(line):
            continue
        line = re.sub(r"elapsed=[0-9.]+s", "elapsed=", line)
        line = re.sub(r"host entropy backend=\w+", "host entropy backend=",
                      line)
        if out_dir:
            line = line.replace(out_dir, "<out>")
        lines.append(line)
    return lines


def _run_both(tool, args, tmp_path, capsys, save=True):
    """Run the JAX tool and the port's on ``args``; returns
    [(rc, stdout lines, {file name: bytes})] for JAX, then the port."""
    results = []
    for side, mod in zip(("jax", "port"), TOOLS[tool]):
        out_dir = tmp_path / side
        out_dir.mkdir(parents=True)
        argv = list(args)
        if save:
            argv += ["-o", str(out_dir) + os.sep]
        if side == "port":
            argv += ["-d", "cpu"]
        rc = mod.main(argv)
        stdout = capsys.readouterr().out
        files = {p.name: p.read_bytes() for p in sorted(out_dir.iterdir())}
        results.append((rc, _normalised(stdout, str(out_dir) + os.sep),
                        files))
    return results


def _assert_same(results, n_files):
    (jrc, jout, jfiles), (trc, tout, tfiles) = results
    assert trc == jrc == 0
    assert tout == jout
    assert sorted(tfiles) == sorted(jfiles)
    assert len(tfiles) == n_files
    for name, data in jfiles.items():
        assert tfiles[name] == data, name


def _counters(results):
    return [line for line in results[1][1] if "decoded" in line
            or "skipped" in line]


@pytest.mark.parametrize("fmt", FORMATS)
def test_jpeg_decode_fmt(corpus_dir, tmp_path, capsys, fmt):
    results = _run_both("decode", ["-i", corpus_dir, "-fmt", fmt],
                        tmp_path, capsys)
    _assert_same(results, 3)
    assert _counters(results) == [
        "info: total decoded images: 3",
        "info: skipped bad/corrupt images: 1",
        "info: skipped 4:1:1 images: 1",
        "info: skipped unsupported-resolution images: 1"]


def test_jpeg_decode_threads_fmt_native(perf_dir, tmp_path, capsys):
    results = _run_both("perf", ["-i", perf_dir, "-fmt", "native",
                                 "-t", "2"], tmp_path, capsys, save=False)
    _assert_same(results, 0)
    assert "info: total decoded images: 3" in results[1][1]


def test_jpeg_decode_perf_mesh(perf_dir, tmp_path, capsys):
    """``--mesh``: the JAX tool over its 8 virtual devices, the port's over
    the host (``-d cpu``); the same counts and lines."""
    results = _run_both("perf", ["-i", perf_dir, "-fmt", "native", "-t", "2",
                                 "--mesh"], tmp_path, capsys, save=False)
    _assert_same(results, 0)
    assert "info: total decoded images: 3" in results[1][1]


def test_jpeg_decode_batch_fmt_native(corpus_dir, tmp_path, capsys):
    results = _run_both("batched", ["-i", corpus_dir, "-fmt", "native",
                                    "-b", "2"], tmp_path, capsys)
    _assert_same(results, 3)
    assert len(_counters(results)) == 4


@pytest.mark.parametrize("fmt", FORMATS)
def test_jpeg_decode_crop_fmt(corpus_dir, tmp_path, capsys, fmt):
    results = _run_both("decode", ["-i", corpus_dir, "-fmt", fmt,
                                   "-crop", CROP], tmp_path, capsys)
    _assert_same(results, 3)


def test_jpeg_decode_crop_batch_fmt_native(corpus_dir, tmp_path, capsys):
    results = _run_both("batched", ["-i", corpus_dir, "-fmt", "native",
                                    "-b", "2", "-crop", CROP],
                        tmp_path, capsys)
    _assert_same(results, 3)


def test_jpeg_decode_valid_crop(corpus_dir, tmp_path, capsys):
    # A crop that fits: the real ROI path, with crop-only channels.
    for fmt in ("rgb", "native"):
        results = _run_both("decode", ["-i", corpus_dir, "-fmt", fmt,
                                       "-crop", "16,16,80,48"],
                            tmp_path / fmt, capsys)
        _assert_same(results, 3)


@pytest.mark.parametrize("tool", list(TOOLS))
def test_tool_without_cuda_says_not_initialized(corpus_dir, capsys,
                                                monkeypatch, tool):
    """No CUDA and no ``-d cpu``: the tool exits non-zero and names the
    status; it never decodes on the host unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = TOOLS[tool][1].main(["-i", corpus_dir])
    assert rc != 0
    assert "NOT_INITIALIZED" in capsys.readouterr().err


def test_perf_mesh_without_cuda_says_not_initialized(corpus_dir, capsys,
                                                     monkeypatch):
    """``--mesh`` without CUDA and without ``-d cpu`` opens no mesh over
    the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert jpegdecodeperf.main(["-i", corpus_dir, "--mesh"]) != 0
    assert "NOT_INITIALIZED" in capsys.readouterr().err


def test_log_err_matches_jax(capsys):
    """The tools' error line: the port's ``log.err`` prints what the JAX
    package's does, to stderr only."""
    log.err("cannot open a decoder")
    mine = capsys.readouterr()
    jlog.err("cannot open a decoder")
    theirs = capsys.readouterr()
    assert (mine.out, mine.err) == (theirs.out, theirs.err)
    assert mine.err == "ERROR: cannot open a decoder\n"
