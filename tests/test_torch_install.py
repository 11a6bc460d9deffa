"""An installed port builds in the user's cache, never beside the package.

``tools.install_check --device cpu`` builds the wheel from a copy of the
checkout, installs it into a fresh venv and decodes from there: the host
library and the C ABI must land in ``$XDG_CACHE_HOME/rocjpeg_tpu_torch``
and nothing under ``site-packages/build/`` (on the tree before this check
existed the libraries went to ``site-packages/build/rocjpeg_tpu_torch``,
inside whatever package owns the name ``build``). A build directory that
cannot be made or written raises the typed build error naming it, never a
bare ``OSError``.
"""

import os

import pytest

from rocjpeg_tpu_torch.kernels import build as kbuild
from rocjpeg_tpu_torch.runtime import build as hbuild
from rocjpeg_tpu_torch.testing import corpus
from rocjpeg_tpu_torch.tools import install_check

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_installed_package_builds_in_the_user_cache():
    res = install_check.run("cpu")
    assert res["ok"] and res["site_packages_build"] is False
    assert res["build_dir"].endswith(os.path.join("cache",
                                                  "rocjpeg_tpu_torch"))
    assert res["decoded"] == ["restart NATIVE x2", "restart RGB x2",
                              "dri0 NATIVE x2", "dri0 RGB x2"]
    assert res["c_sample"].endswith("byte-equal")
    assert set(res["build_s"]) == {"host", "capi"}


def test_checkout_builds_under_its_build_directory():
    assert kbuild.checkout_root() == ROOT
    assert kbuild.build_dir() == os.path.join(ROOT, "build",
                                              "rocjpeg_tpu_torch")
    assert kbuild.BUILD_DIR == kbuild.build_dir()
    assert corpus.DEFAULT_CACHE == os.path.join(ROOT, "build",
                                                "rjt_bench_corpus")


@pytest.mark.parametrize("xdg", [True, False], ids=["xdg", "home"])
def test_installed_layout_uses_the_user_cache(tmp_path, monkeypatch, xdg):
    site = tmp_path / "site-packages"
    (site / "rocjpeg_tpu_torch").mkdir(parents=True)
    monkeypatch.setattr(kbuild, "_PKG", str(site / "rocjpeg_tpu_torch"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    if xdg:
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
        base = tmp_path / "xdg" / "rocjpeg_tpu_torch"
    else:
        monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
        base = tmp_path / "home" / ".cache" / "rocjpeg_tpu_torch"
    assert kbuild.checkout_root() is None
    assert kbuild.build_dir() == str(base)
    assert kbuild.build_dir("rjt_bench_corpus") == str(
        base / "rjt_bench_corpus")
    assert not str(site) in kbuild.build_dir()


def test_another_projects_pyproject_is_not_a_checkout(tmp_path,
                                                      monkeypatch):
    (tmp_path / "pyproject.toml").write_text('[project]\nname = "other"\n')
    (tmp_path / "rocjpeg_tpu_torch").mkdir()
    monkeypatch.setattr(kbuild, "_PKG", str(tmp_path / "rocjpeg_tpu_torch"))
    assert kbuild.checkout_root() is None


def _under_a_file(tmp_path, monkeypatch):
    (tmp_path / "file").write_text("not a directory")
    return str(tmp_path / "file" / "out")


def _makedirs_refused(tmp_path, monkeypatch):
    def refuse(path, *args, **kwargs):
        raise PermissionError(13, "Permission denied", path)
    monkeypatch.setattr(kbuild.os, "makedirs", refuse)
    return str(tmp_path / "site-packages" / "build" / "rocjpeg_tpu_torch")


def _build_host(monkeypatch):
    hbuild.build()


def _build_host_asan(monkeypatch):
    hbuild.build(asan=True)


def _build_capi(monkeypatch):
    hbuild.build_capi()


def _build_kernels(monkeypatch):
    monkeypatch.setattr(kbuild, "_nvcc", lambda: "nvcc")
    kbuild.load()


@pytest.mark.parametrize("where", [_under_a_file, _makedirs_refused],
                         ids=["parent-is-a-file", "permission-denied"])
@pytest.mark.parametrize("what,error", [
    (_build_host, hbuild.HostBuildError),
    (_build_host_asan, hbuild.HostBuildError),
    (_build_capi, hbuild.HostBuildError),
    (_build_kernels, kbuild.KernelBuildError)],
    ids=["host", "host-asan", "capi", "kernels"])
def test_unwritable_build_directory_raises_the_typed_error(
        tmp_path, monkeypatch, where, what, error):
    out = where(tmp_path, monkeypatch)
    monkeypatch.setattr(kbuild, "BUILD_DIR", out)
    monkeypatch.setattr(hbuild, "BUILD_DIR", out)
    with pytest.raises(error) as ei:
        what(monkeypatch)
    assert out in str(ei.value)
    assert not isinstance(ei.value, OSError)


def test_make_build_dir_refuses_a_read_only_directory(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(kbuild.os, "access", lambda path, mode: False)
    with pytest.raises(hbuild.HostBuildError, match="not writable"):
        kbuild.make_build_dir(str(tmp_path), hbuild.HostBuildError)


def test_wheel_sources_and_package_data():
    """The sources a lazy build reads, and the package data that ships
    them, the CMake file and the generated reference."""
    pkg = os.path.join(ROOT, "rocjpeg_tpu_torch")
    found = install_check.needed_sources(pkg)
    assert [p for p in found if p.endswith(".cu")] == [
        "csrc/epilogue.cu", "csrc/sync.cu", "csrc/transform.cu",
        "csrc/wave.cu"]
    assert "csrc/host/rocjpeg_entropy.cpp" in found
    assert "csrc/capi/include/rocjpeg_tpu.h" in found
    assert "csrc/capi/samples/jpegdecode_c.cpp" in found
    with open(os.path.join(ROOT, "pyproject.toml")) as f:
        text = f.read()
    for entry in ('"docs/*.md"', '"csrc/host/CMakeLists.txt"',
                  'torch = ["torch", "numpy"]'):
        assert entry in text, entry
