"""Build the port's native host library and its C ABI.

``rocjpeg_tpu_torch/csrc/host/rocjpeg_entropy.cpp`` (the JPEG header parse,
the entropy decode, the restart-segment packers and the virtual-restart
index walk) is compiled by g++ into one shared library with a plain C
interface (:func:`build`). ``csrc/capi/`` (the embedded-CPython C ABI
library ``librocjpeg_tpu_torch.so`` and the two C samples linked against
it) is compiled by :func:`build_capi`, with the include and link flags of
the interpreter that runs the build. Each build runs on first use, never at
import, and only from the sources in the package; its output lands in
``build/rocjpeg_tpu_torch/`` under a name that carries a hash of the
sources and the flags, so an edited source is rebuilt rather than a stale
build loaded. A missing g++ or a failed build raises
:class:`HostBuildError`; nothing falls back.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sysconfig

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


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise HostBuildError("g++ not found: the native host library cannot "
                             "be built on this machine")
    return gxx


def _run(*cmds) -> None:
    """Run the g++ commands side by side; raise if one fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"g++ failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise HostBuildError("\n".join(failed))


def build() -> str:
    """The path of the built library; compiles it first if it is absent."""
    out = library_path()
    if os.path.exists(out):
        return out
    gxx = _gxx()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    _run([gxx, *GXX_FLAGS, SOURCE, "-o", tmp])
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


CAPI_SRC = os.path.join(CSRC, "capi")
CAPI_LIBRARY = "librocjpeg_tpu_torch.so"
CAPI_SAMPLES = ("jpegdecode_c", "jpegdecodeperf_c")
CAPI_FLAGS = ["-O2", "-std=c++17", "-pthread"]


def _capi_sources():
    return [os.path.join(CAPI_SRC, name) for name in (
        "rocjpeg_capi.cpp", "include/rocjpeg_tpu.h",
        "include/rocjpeg_tpu_version.h",
        *(f"samples/{s}.cpp" for s in CAPI_SAMPLES))]


def python_flags():
    """(compile, link) flags that embed the interpreter running this
    build, from its own ``sysconfig`` (not whichever ``python3-config``
    comes first on PATH): the flags ``python3-config --embed`` prints, plus
    an rpath to the shared libpython, or the export of its symbols to
    extension modules when libpython is static."""
    cfg = sysconfig.get_config_var
    paths = sysconfig.get_paths()
    incs = dict.fromkeys([paths["include"], paths["platinclude"]])
    libdir = cfg("LIBDIR")
    link = [f"-L{libdir}", f"-L{cfg('LIBPL')}",
            f"-lpython{cfg('LDVERSION')}",
            *(cfg("LIBS") or "").split(), *(cfg("SYSLIBS") or "").split()]
    if cfg("Py_ENABLE_SHARED"):
        link.append(f"-Wl,-rpath,{libdir}")
    else:
        link += (cfg("LINKFORSHARED") or "").split()
    return [f"-I{i}" for i in incs], link


def capi_dir() -> str:
    """Directory of the C ABI build for the current sources and
    interpreter (hash in the name)."""
    compile_flags, link_flags = python_flags()
    h = hashlib.sha256(" ".join(
        [*CAPI_FLAGS, *compile_flags, *link_flags]).encode())
    for src in _capi_sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"capi_{h.hexdigest()[:16]}")


def build_capi() -> str:
    """The directory holding ``librocjpeg_tpu_torch.so`` and the samples
    ``jpegdecode_c`` and ``jpegdecodeperf_c``; compiles them first if it is
    absent. The library leaves the Python C API unresolved: a Python
    process that loads it with ctypes provides that API itself, so no
    second libpython is ever loaded; the samples link libpython."""
    out = capi_dir()
    if os.path.isdir(out):
        return out
    gxx = _gxx()
    compile_flags, link_flags = python_flags()
    tmp = f"{out}.tmp{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    try:
        _run([gxx, *CAPI_FLAGS, "-shared", "-fPIC", *compile_flags,
              os.path.join(CAPI_SRC, "rocjpeg_capi.cpp"),
              "-o", os.path.join(tmp, CAPI_LIBRARY)])
        _run(*([gxx, *CAPI_FLAGS,
                os.path.join(CAPI_SRC, "samples", f"{name}.cpp"),
                "-o", os.path.join(tmp, name), f"-L{tmp}",
                "-lrocjpeg_tpu_torch", "-Wl,-rpath,$ORIGIN", *link_flags]
               for name in CAPI_SAMPLES))
        try:
            os.rename(tmp, out)  # atomic: never half a build under `out`
        except OSError:
            if not os.path.isdir(out):  # not a concurrent build's win
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out
