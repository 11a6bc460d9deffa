"""The port stands without jax, and never falls back to the CPU silently.

The machine the port runs on has no jax: ``import rocjpeg_tpu_torch`` must
not import it (the host layer it shares with rocjpeg_tpu is jax-free once
``ROCJPEG_TPU_NO_COMPILE_CACHE`` is set for the first import, which the
port's ``__init__`` does and then undoes).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import rocjpeg_tpu_torch
from rocjpeg_tpu.status import RocJpegError, Status
from rocjpeg_tpu.testing import encoder
from rocjpeg_tpu_torch import api
from rocjpeg_tpu_torch.kernels import transform, wave

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = textwrap.dedent("""
    import importlib.abc, os, sys

    class _RefuseJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith(("jax.", "jaxlib")):
                raise ImportError("jax is refused in this process")
            return None

    sys.meta_path.insert(0, _RefuseJax())
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import rocjpeg_tpu_torch
    from rocjpeg_tpu_torch import api
    from rocjpeg_tpu.testing import encoder
    assert "ROCJPEG_TPU_NO_COMPILE_CACHE" not in os.environ
    blob = encoder.encode_planes(encoder.random_planes("420", 64, 64), "420",
                                 restart_interval=1)
    dec = api.Decoder(device="cpu", device_entropy="on")
    img = dec.decode(api.JpegStream(blob),
                     rocjpeg_tpu_torch.DecodeParams(
                         rocjpeg_tpu_torch.OutputFormat.RGB))
    assert img.channel[0].shape == (64, 192), img.channel[0].shape
    assert [p for p, _ in dec.last_paths] == ["wave"]
    assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
    print("NOJAX-OK")
""")


def test_port_imports_and_decodes_without_jax():
    env = {k: v for k, v in os.environ.items()
           if k != "ROCJPEG_TPU_NO_COMPILE_CACHE"}
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, ROOT],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NOJAX-OK" in proc.stdout


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
    blobs = [encoder.encode_planes(encoder.random_planes("420", 64, 64,
                                                         seed=s), "420",
                                   restart_interval=1) for s in range(2)]
    dec = api.Decoder(device="cpu", device_entropy="on")
    imgs = dec.decode_batched([api.JpegStream(b) for b in blobs])
    assert [p for p, _ in dec.last_paths] == ["wave"]
    assert all(img.channel[0].device.type == "cpu" for img in imgs)
    assert (wave.launches, transform.launches) == (0, 0)


def test_public_names_come_from_the_host_layer():
    from rocjpeg_tpu import status, types
    assert rocjpeg_tpu_torch.RocJpegError is status.RocJpegError
    assert rocjpeg_tpu_torch.OutputFormat is types.OutputFormat
    assert np.array_equal(
        [int(f) for f in rocjpeg_tpu_torch.OutputFormat], [0, 1, 2, 3, 4])


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
