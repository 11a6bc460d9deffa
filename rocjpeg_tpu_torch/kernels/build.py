"""Build and load the port's CUDA kernels.

Every ``rocjpeg_tpu_torch/csrc/*.cu`` is compiled by nvcc for Hopper
(``sm_90a``) into one shared library with a plain C interface, loaded with
ctypes. The build runs on first use, never at import, and only from the
sources in the package; the library lands in ``build/rocjpeg_tpu_torch/``
under a name that carries a hash of the sources, so an edited source is
rebuilt rather than a stale library loaded. A missing nvcc or a failed
build raises; nothing falls back. What ptxas reports of each kernel
(registers, shared memory, spills) is kept beside the library as
``<library>.ptxas.txt``.

Each C entry point launches on the caller's stream and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "rocjpeg_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# C entry point -> argtypes (every pointer and the stream as c_void_p).
SIGNATURES = {
    "rjt_wave_decode": [_P, _L, _P, _P, _P, _P, _P, _I, _P, _P, _I, _P,
                        _I, _I, _I, _I, _L, _L, _P, _P, _P, _P],
    "rjt_wave_lut_size": [],
    "rjt_transform": [_P, _P, _P, _P, _I, _P, _P, _I, _L, _I, _L, _I, _P],
}

_lock = threading.Lock()
_lib = None


class KernelBuildError(RuntimeError):
    """nvcc is missing or the kernels failed to compile."""


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    """nvcc from PATH, else from the CUDA toolkit under CUDA_HOME."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = shutil.which(os.path.join(home, "bin", "nvcc"))
    if nvcc is None:
        raise KernelBuildError("nvcc not found: the CUDA kernels cannot be "
                               "built on this machine")
    return nvcc


def library_path(defines=()) -> str:
    """Path of the library for the current sources (hash in the name);
    ``defines`` are extra ``NAME=value`` macros of a measurement variant."""
    h = hashlib.sha256(" ".join([*NVCC_FLAGS, *defines]).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"librjt_kernels_{h.hexdigest()[:16]}.so")


def _build(out: str, defines=()) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    cus = [s for s in _sources() if s.endswith(".cu")]
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", tmp,
           *cus]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    with open(out + ".ptxas.txt", "w") as f:
        f.write(proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def load(defines=()) -> ctypes.CDLL:
    """Build (if needed) and load the library compiled with ``defines``.
    The package itself runs the library without defines, :func:`library`;
    a variant is for timing one design step of a kernel against another."""
    path = library_path(defines)
    if not os.path.exists(path):
        _build(path, defines)
    lib = ctypes.CDLL(path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load()
        return _lib


def use(lib) -> None:
    """Make ``lib`` (from :func:`load`) the library the wrappers launch:
    how a timing script routes them through a variant. None goes back to
    the package's own library."""
    global _lib
    with _lock:
        _lib = lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
