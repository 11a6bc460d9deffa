"""Build the port's native host library.

``rocjpeg_tpu_torch/csrc/host/rocjpeg_entropy.cpp`` (the JPEG header parse,
the entropy decode, the restart-segment packers and the virtual-restart
index walk) is compiled by g++ into one shared library with a plain C
interface. The build runs on first use, never at import, and only from the
source in the package; the library lands in ``build/rocjpeg_tpu_torch/``
under a name that carries a hash of the source and the flags, so an edited
source is rebuilt rather than a stale library loaded. A missing g++ or a
failed build raises :class:`HostBuildError`; nothing falls back.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

from ..kernels.build import BUILD_DIR, CSRC

SOURCE = os.path.join(CSRC, "host", "rocjpeg_entropy.cpp")
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
             "-fno-exceptions"]


class HostBuildError(RuntimeError):
    """g++ is missing or the host library failed to compile."""


def library_path() -> str:
    """Path of the library for the current source (hash in the name)."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"librjt_host_{h.hexdigest()[:16]}.so")


def build() -> str:
    """The path of the built library; compiles it first if it is absent."""
    out = library_path()
    if os.path.exists(out):
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise HostBuildError("g++ not found: the native host library cannot "
                             "be built on this machine")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [gxx, *GXX_FLAGS, SOURCE, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise HostBuildError(
            f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out
