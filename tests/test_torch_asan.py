"""The AddressSanitizer build of the host library, its override and its
runner.

``runtime.build.build(asan=True)`` compiles the host library with
``-fsanitize=address`` under a name of its own; ``ROCJPEG_TPU_TORCH_HOST_LIB``
makes ``runtime.native`` load a given build, and a path that does not exist
raises rather than fall back; ``python -m rocjpeg_tpu_torch.tools.asan``
runs pytest with the sanitizer preloaded over that build. The sanitizer is
shown able to fail: a heap overflow in a library loaded under the runner's
environment is reported and kills the process.
"""

import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from rocjpeg_tpu_torch.core import bitstream
from rocjpeg_tpu_torch.runtime import build, native
from rocjpeg_tpu_torch.testing import encoder
from rocjpeg_tpu_torch.tools import asan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def asan_library():
    return build.build(asan=True)


def _blob():
    return encoder.encode_planes(encoder.random_planes("420", 64, 48), "420",
                                 restart_interval=2)


def test_variant_name_and_flags(monkeypatch):
    plain, variant = build.library_path(), build.library_path(asan=True)
    assert os.path.dirname(plain) == os.path.dirname(variant)
    assert os.path.basename(variant).startswith("librjt_host_asan_")
    assert os.path.basename(plain).startswith("librjt_host_")
    assert "asan" not in os.path.basename(plain)
    assert build.ASAN_FLAGS[:4] == ["-O1", "-g", "-fno-omit-frame-pointer",
                                    "-fsanitize=address"]
    assert build.ASAN_FLAGS[4:] == [f for f in build.GXX_FLAGS
                                    if f != "-O3"]
    monkeypatch.setattr(build, "ASAN_FLAGS", build.ASAN_FLAGS + ["-DX"])
    assert build.library_path(asan=True) != variant
    assert build.library_path() == plain


def test_variant_is_instrumented(asan_library):
    with open(asan_library, "rb") as f:
        assert b"__asan_init" in f.read()
    with open(build.build(), "rb") as f:
        assert b"__asan_init" not in f.read()


def test_libasan_path_names_a_file():
    path = build.libasan_path()
    assert os.path.isabs(path) and os.path.isfile(path)
    assert "libasan" in os.path.basename(path)


def test_libasan_path_without_a_runtime_raises(monkeypatch, tmp_path):
    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\necho libasan.so\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "_gxx", lambda: str(fake))
    with pytest.raises(build.HostBuildError, match="libasan"):
        build.libasan_path()


def _maps():
    with open("/proc/self/maps") as f:
        return f.read()


def test_override_loads_the_given_file(monkeypatch, tmp_path):
    copy = tmp_path / "librjt_host_copy.so"
    shutil.copy(build.build(), copy)
    monkeypatch.setenv(native.HOST_LIB_ENV, str(copy))
    monkeypatch.setattr(native, "_loaded", None)
    monkeypatch.setattr(build, "build", lambda *a, **k: pytest.fail(
        "the override must not build"))
    assert native.library_file() == str(copy)
    p = bitstream.JpegStreamParser().parse(_blob())
    assert p.picture_width == 64 and p.picture_height == 48
    assert str(copy) in _maps()


def test_override_missing_file_raises(monkeypatch, tmp_path):
    missing = tmp_path / "nowhere" / "librjt_host.so"
    monkeypatch.setenv(native.HOST_LIB_ENV, str(missing))
    monkeypatch.setattr(native, "_loaded", None)
    monkeypatch.setattr(build, "build", lambda *a, **k: pytest.fail(
        "a missing override must not fall back to the package's build"))
    with pytest.raises(build.HostBuildError, match=str(missing)):
        native.library_file()
    with pytest.raises(build.HostBuildError):
        bitstream.JpegStreamParser().parse(_blob())
    assert native._loaded is None


def test_runner_environment_loads_the_variant(asan_library):
    """A process with the runner's environment has libasan and the variant
    mapped, and decodes with it."""
    code = textwrap.dedent("""
        from rocjpeg_tpu_torch.core import bitstream, golden
        from rocjpeg_tpu_torch.runtime import native
        from rocjpeg_tpu_torch.testing import encoder
        from rocjpeg_tpu_torch import OutputFormat
        blob = encoder.encode_planes(encoder.random_planes("420", 64, 48),
                                     "420", restart_interval=2)
        bitstream.JpegStreamParser().parse(blob)
        golden.decode(blob, OutputFormat.RGB)
        maps = open("/proc/self/maps").read()
        print(native.library_file() in maps, "libasan" in maps)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=asan.asan_env(asan_library),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["True", "True"]
    assert asan.REPORT not in proc.stderr


def test_runner_over_the_native_fuzz_is_clean():
    proc = subprocess.run(
        [sys.executable, "-m", "rocjpeg_tpu_torch.tools.asan",
         "tests/test_torch_native_fuzz.py", "-q", "-p", "no:cacheprovider"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert asan.REPORT not in proc.stderr
    assert "7 passed" in proc.stdout
    assert "librjt_host_asan_" in proc.stdout


HEAP_OVERFLOW = """
#include <stdlib.h>
int overflow(int n) {
    char *p = (char *)malloc(n);
    p[n] = 1;  /* one byte past the block */
    int r = p[0];
    free(p);
    return r;
}
"""


def test_sanitizer_reports_a_heap_overflow(tmp_path, asan_library):
    src = tmp_path / "overflow.c"
    lib = tmp_path / "liboverflow.so"
    src.write_text(HEAP_OVERFLOW)
    subprocess.run(["gcc", "-O1", "-g", "-fsanitize=address", "-shared",
                    "-fPIC", str(src), "-o", str(lib)], check=True)
    code = (f"import ctypes; ctypes.CDLL({str(lib)!r}).overflow(16); "
            "print('survived')")
    proc = subprocess.run([sys.executable, "-c", code],
                          env=asan.asan_env(asan_library),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "heap-buffer-overflow" in proc.stderr
    assert asan.REPORT in proc.stderr
    assert "survived" not in proc.stdout


def test_runner_fails_on_a_report_pytest_missed(tmp_path):
    """A report on stderr fails the run even when pytest passed."""
    test = tmp_path / "test_reports.py"
    test.write_text("import sys\n\ndef test_x():\n"
                    f"    sys.stderr.write({asan.REPORT!r} + ': x\\n')\n")
    assert asan.main([str(test), "-q", "-s", "-p", "no:cacheprovider"]) == 1
