"""The port stands on its own, and never falls back to the CPU silently.

The machine the port runs on has no jax: ``rocjpeg_tpu_torch`` and
``chip_smoke.py`` import neither jax nor anything of the JAX package
``rocjpeg_tpu`` (nor ``bench``, which imports it). The port keeps its own
copy of the host layer.
"""

import os
import pkgutil
import re
import subprocess
import sys
import textwrap

import pytest
import torch

import rocjpeg_tpu_torch
from rocjpeg_tpu_torch import api
from rocjpeg_tpu_torch.kernels import epilogue, transform, wave
from rocjpeg_tpu_torch.status import RocJpegError, Status
from rocjpeg_tpu_torch.testing import encoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_STANDALONE = textwrap.dedent("""
    import importlib.abc, pkgutil, sys

    def _refused(name):
        return (name in ("jax", "jaxlib", "rocjpeg_tpu", "bench")
                or name.startswith(("jax.", "jaxlib.", "rocjpeg_tpu.")))

    class _Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if _refused(name):
                raise ImportError(name + " is refused in this process")
            return None

    sys.meta_path.insert(0, _Refuse())
    sys.path.insert(0, sys.argv[1])
    import importlib
    import numpy as np
    import rocjpeg_tpu_torch
    for info in pkgutil.walk_packages(rocjpeg_tpu_torch.__path__,
                                      "rocjpeg_tpu_torch."):
        importlib.import_module(info.name)
    from rocjpeg_tpu_torch import api
    from rocjpeg_tpu_torch.core import golden
    from rocjpeg_tpu_torch.testing import encoder
    RGB = rocjpeg_tpu_torch.OutputFormat.RGB
    blob = encoder.encode_planes(encoder.random_planes("420", 64, 64), "420",
                                 restart_interval=1)
    want = golden.decode(blob, RGB)[0][0]
    for mode, path in (("on", "wave"), ("off", "host")):
        dec = api.Decoder(device="cpu", device_entropy=mode)
        img = dec.decode(api.JpegStream(blob),
                         rocjpeg_tpu_torch.DecodeParams(RGB))
        assert img.channel[0].shape == (64, 192), img.channel[0].shape
        assert [p for p, _ in dec.last_paths] == [path]
        assert np.array_equal(img.channel[0].numpy(), want)
    # The user-facing surface: a CLI run and a C ABI decode.
    import os, tempfile
    from rocjpeg_tpu_torch import capi
    from rocjpeg_tpu_torch.tools import jpegdecode
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "a.jpg"), "wb") as f:
            f.write(blob)
        assert jpegdecode.main(["-i", d, "-fmt", "rgb", "-d", "cpu",
                                "-o", os.path.join(d, "out_")]) == 0
        with open(os.path.join(d, "out_a_64x64_packed.rgb"), "rb") as f:
            assert f.read() == want.tobytes()
    os.environ[capi.DEVICE_ENV] = "cpu"
    _, stream = capi.stream_create()
    assert capi.stream_parse(stream, blob) == 0
    status, handle = capi.create()
    assert status == 0, status
    dest = np.zeros(want.size, np.uint8)
    assert capi.decode(handle, stream, int(RGB), (0, 0, 0, 0),
                       [dest, None, None, None], [192, 0, 0, 0]) == 0
    assert np.array_equal(dest, want.reshape(-1))
    assert not [m for m in sys.modules if _refused(m)]
    print("STANDALONE-OK")
""")


def test_port_imports_and_decodes_without_jax():
    """Every module of the port imports, and an image decodes on the
    device-entropy path and on the host path, in a process whose import
    system refuses jax and rocjpeg_tpu."""
    proc = subprocess.run([sys.executable, "-c", _STANDALONE, ROOT],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "STANDALONE-OK" in proc.stdout


_FOREIGN_IMPORT = re.compile(
    r"^\s*(from|import)\s+(rocjpeg_tpu(\.|\s|$)|jax|bench)", re.M)


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _dirs, names in os.walk(os.path.dirname(
            rocjpeg_tpu_torch.__file__)):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_port_sources_import_nothing_of_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 20
    pkg = os.path.dirname(rocjpeg_tpu_torch.__file__)
    for part in ("tools/common.py", "tools/jpegdecode.py",
                 "tools/jpegdecodebatched.py", "tools/jpegdecodeperf.py",
                 "capi.py", "core/golden.py", "utils/log.py",
                 "tools/asan.py", "tools/install_check.py",
                 "tools/setup_check.py", "tools/gen_api_doc.py",
                 "tools/docker_check.py", "tools/bench.py",
                 "tools/threads_sweep.py", "tools/profile_stages.py",
                 "tools/profile_walk.py", "tools/scaling.py"):
        assert os.path.join(pkg, part) in sources, part
    for path in sources:
        with open(path) as f:
            hit = _FOREIGN_IMPORT.search(f.read())
        assert hit is None, f"{path}: {hit.group(0).strip()!r}"


def test_bench_walk_is_built_from_the_package_alone():
    """``csrc/host/bench_walk.cpp`` lies in the package, its build (in
    ``tools/profile_walk.py``, which the scan above covers) links the
    port's host library, and neither names a file of the JAX package."""
    from rocjpeg_tpu_torch.tools import profile_walk
    pkg = os.path.dirname(rocjpeg_tpu_torch.__file__)
    src = profile_walk.BENCH_WALK_SOURCE
    assert os.path.commonpath([src, pkg]) == pkg
    assert os.path.join(pkg, "tools", "profile_walk.py") in _port_sources()
    for path in (src, profile_walk.__file__):
        with open(path) as f:
            text = f.read()
        assert "rocjpeg_tpu/" not in text and "librocjpeg_host" not in text


def test_c_abi_shim_imports_only_the_port():
    """The embedded interpreter of ``librocjpeg_tpu_torch.so`` imports the
    port's ``capi`` and nothing else of a package; the C sources include
    only the port's own header copy."""
    capi_src = os.path.join(os.path.dirname(rocjpeg_tpu_torch.__file__),
                            "csrc", "capi")
    with open(os.path.join(capi_src, "rocjpeg_capi.cpp")) as f:
        shim = f.read()
    assert re.findall(r'PyImport_ImportModule\("([^"]+)"\)', shim) == [
        "rocjpeg_tpu_torch.capi"]
    code = "\n".join(re.findall(r'"((?:[^"\\]|\\.)*)\\n"', shim))
    assert set(re.findall(r"\bimport ([\w, ]+)", code)) == {"os, sys"}
    for base, _dirs, names in os.walk(capi_src):
        for name in names:
            with open(os.path.join(base, name)) as f:
                text = f.read()
            for inc in re.findall(r'#include "([^"]+)"', text):
                assert not inc.startswith("../../"), (name, inc)
            assert "jax" not in text.lower().replace("jax package", ""), name


def test_every_port_module_is_packaged():
    """pyproject.toml names every sub-package of the port."""
    with open(os.path.join(ROOT, "pyproject.toml")) as f:
        text = f.read()
    names = ["rocjpeg_tpu_torch"] + [
        info.name for info in pkgutil.walk_packages(
            rocjpeg_tpu_torch.__path__, "rocjpeg_tpu_torch.") if info.ispkg]
    assert len(names) >= 6
    for name in names:
        assert f'"{name}"' in text, name


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RocJpegError) as ei:
        api.Decoder()
    assert ei.value.status == Status.NOT_INITIALIZED
    with pytest.raises(RocJpegError) as ei:
        api.Decoder(device="cuda:0")
    assert ei.value.status == Status.NOT_INITIALIZED


def test_bad_device_and_mode_rejected():
    for kwargs in ({"device": "meta"}, {"device": "cpu",
                                        "device_entropy": "sometimes"}):
        with pytest.raises(RocJpegError) as ei:
            api.Decoder(**kwargs)
        assert ei.value.status == Status.INVALID_PARAMETER


def test_cpu_decode_launches_no_kernel(monkeypatch):
    monkeypatch.setattr(wave, "launches", 0)
    monkeypatch.setattr(transform, "launches", 0)
    monkeypatch.setattr(epilogue, "launches", 0)
    blobs = [encoder.encode_planes(encoder.random_planes("420", 64, 64,
                                                         seed=s), "420",
                                   restart_interval=1) for s in range(2)]
    dec = api.Decoder(device="cpu", device_entropy="on")
    imgs = dec.decode_batched([api.JpegStream(b) for b in blobs])
    assert [p for p, _ in dec.last_paths] == ["wave"]
    assert all(img.channel[0].device.type == "cpu" for img in imgs)
    assert (wave.launches, transform.launches, epilogue.launches) == (0, 0, 0)


@pytest.mark.parametrize("name", ["Status", "OutputFormat",
                                  "ChromaSubsampling"])
def test_public_enums_match_the_jax_package(name):
    """The port's enums are its own classes with the JAX package's member
    names and integer values."""
    from rocjpeg_tpu import status, types
    theirs = getattr(status if name == "Status" else types, name)
    mine = getattr(rocjpeg_tpu_torch, name)
    assert mine is not theirs
    assert mine.__module__.startswith("rocjpeg_tpu_torch.")
    assert ({m.name: int(m) for m in mine}
            == {m.name: int(m) for m in theirs})
    assert rocjpeg_tpu_torch.RocJpegError is not status.RocJpegError


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    from rocjpeg_tpu_torch.kernels import build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(build.KernelBuildError):
        build._nvcc()


def test_kernel_library_name_follows_sources(monkeypatch, tmp_path):
    """An edited source gets a new library name, so a stale build is never
    loaded."""
    import shutil
    from rocjpeg_tpu_torch.kernels import build
    for src in build._sources():
        shutil.copy(src, tmp_path)
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    before = build.library_path()
    with open(tmp_path / "wave.cu", "a") as f:
        f.write("// edited\n")
    assert build.library_path() != before
    assert os.path.dirname(before) == build.BUILD_DIR
