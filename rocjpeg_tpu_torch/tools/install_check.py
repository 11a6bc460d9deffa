"""Check the installed package: build its wheel, install it into a fresh
virtual environment, and decode from there.

    python -m rocjpeg_tpu_torch.tools.install_check [--device cpu|cuda]

The counterpart of the JAX package's ``ci/install_check.sh``. Steps:

1. copy ``pyproject.toml``, ``README.md`` and both package directories of
   the checkout to a temporary directory and build the wheel there
   (``pip wheel --no-deps --no-build-isolation``), never in the checkout;
2. check that the wheel holds every source a lazy build needs
   (``csrc/*.cu``, ``csrc/host/*.cpp``, ``csrc/capi/**``);
3. install it with ``--no-index --no-deps`` into a fresh
   ``venv --system-site-packages --without-pip``, with a ``.pth`` naming
   this interpreter's site-packages (torch, numpy and pip, which runs in
   the venv's interpreter), since this interpreter may itself be a venv
   that the new one's base does not see;
4. from a neutral working directory, import ``rocjpeg_tpu_torch`` and check
   that it resolves inside the venv;
5. build the host library (and on ``cuda`` K1, K2 and K3 with nvcc) from
   the installed sources, and decode synthesized 4:2:0 frames of 64x64 on
   the device, with restart markers and without (DRI=0), NATIVE and RGB,
   byte-equal to ``core.golden``; on ``cuda`` count the kernels' launches;
6. check that the libraries landed in the per-user cache
   (``kernels.build.build_dir``, under a private ``XDG_CACHE_HOME``) and
   that nothing was created under ``site-packages/build/``;
7. build the C ABI from the installed package and run ``jpegdecode_c``
   against it (``ROCJPEG_TPU_ROOT=<venv site-packages>``), its file
   byte-equal to ``core.golden``.

Exits 0 when every step holds; prints one ``[install]`` line a step and
the result as JSON on the last line. Nothing is installed outside the
temporary directory, which is removed at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import time
import zipfile

from ..kernels import build as kbuild

PACKAGES = ("rocjpeg_tpu", "rocjpeg_tpu_torch")
# What the wheel is built from: the project's two files and both packages.
SOURCES = ("pyproject.toml", "README.md", *PACKAGES)
# No network, no dependencies, and nothing written to the user's pip cache.
PIP_FLAGS = ["--no-index", "--no-deps", "--no-cache-dir",
             "--disable-pip-version-check", "-q"]

# Runs in the venv's interpreter; argv: device, expected site-packages,
# scratch directory. Prints one JSON line.
_CHILD = r'''
import concurrent.futures, json, os, subprocess, sys, time
device, site, scratch = sys.argv[1:4]
import rocjpeg_tpu_torch
pkg = os.path.dirname(rocjpeg_tpu_torch.__file__)
if os.path.dirname(pkg) != site:
    raise SystemExit(f"rocjpeg_tpu_torch resolved to {pkg}, not {site}")
import numpy as np
import torch
from rocjpeg_tpu_torch import DecodeParams, OutputFormat, api, capi
from rocjpeg_tpu_torch.core import golden
from rocjpeg_tpu_torch.kernels import build as kbuild
from rocjpeg_tpu_torch.kernels import epilogue, transform, wave
from rocjpeg_tpu_torch.runtime import build as hbuild
from rocjpeg_tpu_torch.testing import encoder

def timed(fn):
    t0 = time.perf_counter()
    return fn(), time.perf_counter() - t0

def kernels():
    kbuild.library()
    return kbuild.library_path()

res = {"package": pkg, "build_dir": kbuild.BUILD_DIR,
       "python_path": [p for p in sys.path if p]}
jobs = {"host": hbuild.build, "capi": hbuild.build_capi}
if device == "cuda":
    jobs["kernels"] = kernels
with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
    futs = {k: pool.submit(timed, fn) for k, fn in jobs.items()}
    built = {k: f.result() for k, f in futs.items()}
res["built"] = {k: path for k, (path, _) in built.items()}
res["build_s"] = {k: round(s, 3) for k, (_, s) in built.items()}

blobs = {name: [encoder.encode_planes(encoder.random_planes("420", 64, 64,
                                                            seed=s), "420",
                                      restart_interval=ri) for s in (0, 1)]
         for name, ri in (("restart", 1), ("dri0", 0))}
want_path = {"restart": "wave", "dri0": "wave-virtual"}
for mod in (wave, transform, epilogue):
    mod.launches = 0
dec = api.Decoder(device=device, device_entropy="on")
checked = []
for name, group in blobs.items():
    for fmt in (OutputFormat.NATIVE, OutputFormat.RGB):
        imgs = dec.decode_batched([api.JpegStream(b) for b in group],
                                  DecodeParams(fmt))
        paths = [p for p, _ in dec.last_paths]
        if paths != [want_path[name]]:
            raise SystemExit(f"{name} {fmt.name}: paths {paths}")
        for i, (img, blob) in enumerate(zip(imgs, group)):
            for ci, (arr, pitch) in enumerate(golden.decode(blob, fmt)):
                got = img.channel[ci].cpu().numpy()
                if got.shape != arr.shape or not np.array_equal(got, arr) \
                        or img.pitch[ci] != pitch:
                    raise SystemExit(f"{name} {fmt.name} image {i} channel "
                                     f"{ci} differs from core.golden")
        checked.append(f"{name} {fmt.name} x{len(group)}")
if device == "cuda":
    torch.cuda.synchronize()
res["decoded"] = checked
res["launches"] = {"wave": wave.launches, "transform": transform.launches,
                   "epilogue": epilogue.launches}

src = os.path.join(scratch, "frame.jpg")
out = os.path.join(scratch, "frame.rgb")
with open(src, "wb") as f:
    f.write(blobs["restart"][0])
env = dict(os.environ, ROCJPEG_TPU_ROOT=site,
           PYTHONPATH=os.pathsep.join(res["python_path"]))
env.pop(capi.DEVICE_ENV, None)
if device == "cpu":
    env[capi.DEVICE_ENV] = "cpu"
r = subprocess.run([os.path.join(res["built"]["capi"], "jpegdecode_c"),
                    "-i", src, "-fmt", "rgb", "-o", out], env=env,
                   capture_output=True, text=True, timeout=300)
if r.returncode != 0:
    raise SystemExit(f"jpegdecode_c exited {r.returncode}:\n{r.stdout}\n"
                     f"{r.stderr}")
with open(out, "rb") as f:
    if f.read() != golden.decode(blobs["restart"][0],
                                 OutputFormat.RGB)[0][0].tobytes():
        raise SystemExit("jpegdecode_c's file differs from core.golden")
res["c_sample"] = "jpegdecode_c -fmt rgb: exit 0, file byte-equal"
print(json.dumps(res))
'''


class InstallCheckError(RuntimeError):
    """A step of the installed-package check failed."""


def _log(msg: str) -> None:
    print(f"[install] {msg}", flush=True)


def run_checked(cmd, error: type = InstallCheckError,
                **kw) -> subprocess.CompletedProcess:
    """Run ``cmd`` capturing its output; raise ``error`` with both streams
    when it exits non-zero."""
    proc = subprocess.run(cmd, capture_output=True, text=True, **kw)
    if proc.returncode != 0:
        raise error(f"{' '.join(cmd)} exited {proc.returncode}:"
                    f"\n{proc.stdout}\n{proc.stderr}")
    return proc


def copy_source(root: str, dest: str, names=SOURCES) -> None:
    """Copy each of ``names`` (a file or a directory, relative to
    ``root``) into ``dest``, leaving out bytecode and built libraries."""
    ignore = shutil.ignore_patterns("__pycache__", "*.pyc", "*.so")
    skip = ignore(root, names)
    for name in names:
        if name in skip:
            continue
        src = os.path.join(root, name)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(dest, os.path.basename(src)),
                            ignore=ignore, dirs_exist_ok=True)
        else:
            shutil.copy(src, dest)


def needed_sources(pkg_dir: str) -> list:
    """Package-relative paths of every source a lazy build reads:
    ``csrc/*.cu``, ``csrc/host/*.cpp`` and everything under
    ``csrc/capi``."""
    csrc = os.path.join(pkg_dir, "csrc")
    found = []
    for base, dirs, names in os.walk(csrc):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        rel = os.path.relpath(base, pkg_dir)
        for n in names:
            path = os.path.join(rel, n)
            if ((rel == "csrc" and n.endswith(".cu"))
                    or (rel == os.path.join("csrc", "host")
                        and n.endswith(".cpp"))
                    or path.startswith(os.path.join("csrc", "capi", ""))):
                found.append(path)
    return sorted(found)


def clean_env() -> dict:
    """This process's environment without what would point an installed
    package back at the checkout: ``PYTHONPATH``, the host-library
    override and the corpus cache."""
    return {k: v for k, v in os.environ.items()
            if k not in ("PYTHONPATH", "ROCJPEG_TPU_TORCH_HOST_LIB",
                         "BENCH_CORPUS_CACHE")}


def make_venv(venv: str, error: type = InstallCheckError) -> tuple:
    """A fresh ``venv --system-site-packages --without-pip`` at ``venv``
    whose ``.pth`` names this interpreter's site-packages (torch, numpy and
    pip, which then runs in the venv's interpreter); return its python and
    its site-packages."""
    run_checked([sys.executable, "-m", "venv", "--system-site-packages",
                 "--without-pip", venv], error)
    python = os.path.join(venv, "bin", "python")
    site = run_checked([python, "-c", "import sysconfig; "
                        "print(sysconfig.get_paths()['purelib'])"],
                       error).stdout.strip()
    parent = dict.fromkeys([sysconfig.get_paths()["purelib"],
                            sysconfig.get_paths()["platlib"]])
    with open(os.path.join(site, "_parent_env.pth"), "w") as f:
        f.write("\n".join(parent) + "\n")
    return python, site


def run(device: str = "cpu") -> dict:
    """Run every step over the checkout that holds this package; return
    the results, or raise InstallCheckError."""
    root = kbuild.checkout_root()
    if root is None:
        raise InstallCheckError("the package is not in a source checkout")
    t_all = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="rjt_install_")
    res = {"device": device, "root": root}
    try:
        src = os.path.join(tmp, "src")
        os.makedirs(src)
        copy_source(root, src)
        t0 = time.perf_counter()
        run_checked([sys.executable, "-m", "pip", "wheel", src, *PIP_FLAGS,
                     "--no-build-isolation", "-w", os.path.join(tmp, "dist")])
        res["wheel_s"] = round(time.perf_counter() - t0, 3)
        (wheel,) = [os.path.join(tmp, "dist", n)
                    for n in os.listdir(os.path.join(tmp, "dist"))]
        _log(f"1. wheel {os.path.basename(wheel)} built from a copy of "
             f"{root} in {res['wheel_s']:.1f} s")

        with zipfile.ZipFile(wheel) as z:
            names = set(z.namelist())
        want = [f"rocjpeg_tpu_torch/{p}" for p in
                needed_sources(os.path.join(root, "rocjpeg_tpu_torch"))]
        missing = [p for p in want if p not in names]
        if missing or not want:
            raise InstallCheckError(f"the wheel lacks sources: {missing}")
        _log(f"2. the wheel holds all {len(want)} sources of a lazy build")

        venv = os.path.join(tmp, "venv")
        t0 = time.perf_counter()
        python, site = make_venv(venv)
        run_checked([python, "-m", "pip", "install", *PIP_FLAGS, wheel])
        res["install_s"] = round(time.perf_counter() - t0, 3)
        res["site_packages"] = site
        _log(f"3. installed into a fresh venv in {res['install_s']:.1f} s "
             f"({site})")

        cwd = os.path.join(tmp, "cwd")
        cache = os.path.join(tmp, "cache")
        os.makedirs(cwd)
        env = clean_env()
        env["XDG_CACHE_HOME"] = cache
        t0 = time.perf_counter()
        child = run_checked([python, "-c", _CHILD, device, site, cwd],
                            cwd=cwd, env=env, timeout=1200)
        res["child_s"] = round(time.perf_counter() - t0, 3)
        got = json.loads(child.stdout.strip().splitlines()[-1])
        _log(f"4. import from {cwd}: {got['package']}")
        res.update({k: got[k] for k in ("build_s", "decoded", "launches",
                                        "c_sample", "build_dir")})
        if device == "cuda" and min(got["launches"].values()) < 1:
            raise InstallCheckError(f"a kernel never launched: "
                                    f"{got['launches']}")
        _log(f"5. built from the installed sources {got['build_s']} s; "
             f"decoded {', '.join(got['decoded'])} on {device}, byte-equal "
             f"to core.golden; kernel launches {got['launches']}")

        want_dir = os.path.join(cache, "rocjpeg_tpu_torch")
        if got["build_dir"] != want_dir:
            raise InstallCheckError(f"the installed package builds in "
                                    f"{got['build_dir']}, not {want_dir}")
        for what, path in got["built"].items():
            if os.path.dirname(path) != want_dir or not os.path.exists(path):
                raise InstallCheckError(f"{what} build at {path}, not in "
                                        f"{want_dir}")
        stray = os.path.join(site, "build")
        res["site_packages_build"] = os.path.exists(stray)
        if res["site_packages_build"]:
            raise InstallCheckError(f"the installed package wrote {stray}: "
                                    f"{sorted(os.listdir(stray))}")
        _log(f"6. libraries in {want_dir}: "
             f"{sorted(os.path.basename(p) for p in got['built'].values())};"
             f" no {stray}")
        _log(f"7. {got['c_sample']}")
        res["total_s"] = round(time.perf_counter() - t_all, 3)
        res["ok"] = True
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where the installed package decodes "
                         "(default cuda)")
    args = ap.parse_args(argv)
    try:
        res = run(args.device)
    except (InstallCheckError, subprocess.TimeoutExpired) as e:
        print(f"install check FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
