"""The JAX package's host library, loaded for every port test that compares
against it.

``rocjpeg_tpu.runtime.native`` builds ``librocjpeg_host.so`` when it is first
imported and the file is absent (a fresh checkout: the library is not
committed), writing g++'s output straight onto the final path. Under
``pytest -n N`` every worker imports that module while collecting, so a
worker can load the file while another is still writing it: ``ctypes``
raises, the module keeps ``_lib = None`` for the life of the process, and
every parity test on that worker fails with "native library unavailable".

:func:`jax_native` repairs that before a port test runs. It never opens a
file that another process may still be writing (``dlopen`` of a partly
written library can also kill the process with SIGBUS). Under a file lock
it builds the library once, with the JAX package's own build script, into
a temporary file that ``os.replace`` moves to a path of its own under
``build/`` (named after the source, so a file there is always complete),
then reloads ``native`` from that path and ``host_decode``, which copies
``AVAILABLE`` when it is imported, and clears the parser's cached choice of
its native parse. The port test files take it as an autouse fixture.
Nothing is skipped and no comparison changes: the tests run
against the library they would have loaded had the race not happened.
:func:`test_lost_build_race_is_repaired` replays a lost race.
"""

import fcntl
import hashlib
import importlib
import importlib.util
import os
import tempfile

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_SCRIPT = os.path.join(ROOT, "csrc", "build.py")
REPAIR_DIR = os.path.join(ROOT, "build", "jax_host_library")


def _repair_path() -> str:
    """Where the repair keeps its build: named after the build script and
    the source it compiles."""
    digest = hashlib.sha256()
    for path in (BUILD_SCRIPT, os.path.join(ROOT, "csrc",
                                            "rocjpeg_entropy.cpp")):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(REPAIR_DIR,
                        f"librocjpeg_host_{digest.hexdigest()[:16]}.so")


def _build_into(path: str) -> None:
    """Build the JAX package's host library with its own build script into
    a temporary file beside ``path``, then move it onto ``path``."""
    spec = importlib.util.spec_from_file_location("rjt_csrc_build",
                                                  BUILD_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
    os.close(fd)
    try:
        mod.OUT = tmp  # build() reads the output path from the module
        mod.build(verbose=False)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _reload(lib_path=None):
    """Reload the JAX ``native`` module (from ``lib_path`` when given, by
    its own ``ROCJPEG_HOST_LIB`` override, restored afterwards) and
    ``host_decode``, and have the parser look up its native parse again
    (``core.bitstream`` caches it at its first parse)."""
    from rocjpeg_tpu.core import bitstream as jbitstream
    from rocjpeg_tpu.runtime import host_decode as jhost
    from rocjpeg_tpu.runtime import native as jnative
    saved = os.environ.get("ROCJPEG_HOST_LIB")
    if lib_path is not None:
        os.environ["ROCJPEG_HOST_LIB"] = lib_path
    try:
        importlib.reload(jnative)
    finally:
        if saved is None:
            os.environ.pop("ROCJPEG_HOST_LIB", None)
        else:
            os.environ["ROCJPEG_HOST_LIB"] = saved
    importlib.reload(jhost)
    jbitstream._NATIVE_PARSER = ("unset",)
    return jnative


def ensure_jax_native():
    """The JAX package's ``runtime.native`` module with its library loaded,
    whatever happened when this process first imported it. Raises if the
    library can be neither built nor loaded."""
    from rocjpeg_tpu.runtime import native as jnative
    if jnative._lib is not None:
        return jnative
    path = _repair_path()
    os.makedirs(REPAIR_DIR, exist_ok=True)
    with open(os.path.join(REPAIR_DIR, "lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(path):
                _build_into(path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    jnative = _reload(path)
    if jnative._lib is None:
        raise RuntimeError(f"the JAX host library {path} does not load")
    return jnative


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package's host library, loaded (see the module docstring)."""
    return ensure_jax_native()


@pytest.fixture
def lost_race(monkeypatch, tmp_path):
    """The JAX module as a worker that lost the build race sees it: the
    library path it loads holds the first bytes of a library being written,
    so its import left ``_lib = None``. The state before is restored
    afterwards."""
    from rocjpeg_tpu.runtime import native as jnative
    before = jnative._LIB_PATH
    partial = tmp_path / "librocjpeg_host.so"
    with open(before, "rb") as f:
        partial.write_bytes(f.read(64))  # the ELF header, and no more
    monkeypatch.setenv("ROCJPEG_HOST_LIB", str(partial))
    yield partial
    monkeypatch.undo()
    _reload(before)
    ensure_jax_native()


def test_lost_build_race_is_repaired(lost_race):
    """A lost race replayed: the module loads nothing, the repair loads a
    complete build and reloads, and the parity tests that fail after such
    a race then run and pass."""
    import test_torch_banked as banked
    import test_torch_hostlayer as hostlayer
    from rocjpeg_tpu.runtime import host_decode as jhost

    jnative = _reload()
    assert jnative._LIB_PATH == str(lost_race)
    assert jnative._lib is None and not jhost.NATIVE_AVAILABLE
    with pytest.raises(RuntimeError, match="native library unavailable"):
        hostlayer.test_native_decode_scan_matches_jax("420", 0, 0)

    jnative = ensure_jax_native()
    assert jnative._LIB_PATH == _repair_path()
    assert jnative._lib is not None and jhost.NATIVE_AVAILABLE
    assert os.environ["ROCJPEG_HOST_LIB"] == str(lost_race)
    hostlayer.test_native_decode_scan_matches_jax("420", 0, 0)
    hostlayer.test_native_restart_packer_matches_jax("422", 1, 1)
    hostlayer.test_native_index_walk_and_pack_bits_match_jax("420", 0, 0)
    hostlayer.test_broken_scan_same_status("garbage", 2)
    banked.test_banked_wave_virtual_restarts(2)


def test_loaded_library_is_left_alone(monkeypatch):
    """With the library loaded, the fixture neither rebuilds nor reloads."""
    jnative = ensure_jax_native()
    lib = jnative._lib

    def no_build(path):
        raise AssertionError(f"rebuilt {path}")

    monkeypatch.setattr(f"{__name__}._build_into", no_build)
    assert ensure_jax_native() is jnative and jnative._lib is lib
    assert np.asarray(jnative.seg_lens(b"\x00" * 8, 1)[0]).size == 1
