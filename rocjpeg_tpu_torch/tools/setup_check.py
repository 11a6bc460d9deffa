"""Check the toolchain, build the port's libraries, decode one frame.

    python -m rocjpeg_tpu_torch.tools.setup_check [--device cpu|cuda]
                                                  [--build-only]

The counterpart of the JAX package's ``rocjpeg-tpu-setup.py``. It reports
Python >= 3.10, g++, numpy and torch; on ``cuda`` (the default) also nvcc,
a CUDA device of compute capability 9.0 and the driver's name and power
limit. Then it builds the host library, the C ABI and, on ``cuda``, the
kernels K1, K2 and K3, and decodes one synthesized 4:2:0 frame on the
device, held byte for byte against ``core.golden``.

With ``--build-only`` it checks the compilers and builds the libraries
into ``kernels.build.build_dir()`` and stops: no card, driver or decode is
needed or checked, since nvcc compiles for ``sm_90a`` without a card. A
container image runs it as a build step, so that its first decode compiles
nothing.

It installs nothing: for each missing piece it prints the command that
would supply it, since the machines it runs on need not have a network.
It exits 1 on any miss. Without ``--device`` it checks for the card and
fails on a machine without one; it does not check the CPU instead. The
last line of its output is the result as JSON.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import subprocess
import sys
import time

FIXES = {
    "python": "install Python 3.10 or newer",
    "g++": "apt-get install g++",
    "numpy": "pip install numpy",
    "torch": "pip install torch",
    "nvcc": "install the CUDA toolkit and put its bin/ on PATH "
            "(or set CUDA_HOME)",
    "card": "a Hopper GPU (compute capability 9.0) and a CUDA build of "
            "torch (pip install torch --index-url "
            "https://download.pytorch.org/whl/cu128)",
    "driver": "install the NVIDIA driver (nvidia-smi)",
}


class _Report:
    def __init__(self):
        self.missing = []

    def check(self, ok: bool, what: str, key: str, detail: str = "") -> bool:
        mark = "ok" if ok else "MISSING"
        line = f"[setup] [{mark:7s}] {what}" + (f": {detail}" if detail
                                                 else "")
        if not ok:
            line += f"  -> {FIXES[key]}"
            self.missing.append(key)
        print(line, flush=True)
        return ok


def _card(report: _Report) -> None:
    import torch
    ok = torch.cuda.is_available()
    detail = "torch.cuda.is_available() is false"
    if ok:
        cap = torch.cuda.get_device_capability(0)
        detail = (f"{torch.cuda.get_device_name(0)}, compute capability "
                  f"{cap[0]}.{cap[1]}, torch {torch.__version__} cuda "
                  f"{torch.version.cuda}")
        ok = cap == (9, 0)
    report.check(ok, "CUDA device of compute capability 9.0", "card",
                 detail)
    smi = shutil.which("nvidia-smi")
    out = ""
    if smi:
        proc = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True)
        out = proc.stdout.strip().splitlines()[0] if proc.returncode == 0 \
            and proc.stdout.strip() else ""
    report.check(bool(out), "driver: name, power limit", "driver",
                 out or "nvidia-smi gave nothing")


def check_toolchain(device: str, card: bool = True) -> list:
    """Report every prerequisite; return the keys of those missing. With
    ``card`` false a ``cuda`` check stops at nvcc: what a build needs."""
    report = _Report()
    report.check(sys.version_info >= (3, 10), "python >= 3.10", "python",
                 sys.version.split()[0])
    report.check(shutil.which("g++") is not None, "g++", "g++",
                 shutil.which("g++") or "not on PATH")
    for mod in ("numpy", "torch"):
        report.check(importlib.util.find_spec(mod) is not None, mod, mod)
    if device == "cuda":
        from ..kernels import build as kbuild
        try:
            nvcc, ok = kbuild._nvcc(), True
        except kbuild.KernelBuildError as e:
            nvcc, ok = str(e), False
        report.check(ok, "nvcc", "nvcc", nvcc)
        if card and "torch" not in report.missing:
            _card(report)
    return report.missing


def build_libraries(device: str) -> dict:
    """Build the host library, the C ABI and, on ``cuda``, the kernels K1,
    K2 and K3 (without loading them); return each build's seconds."""
    from ..kernels import build as kbuild
    from ..runtime import build as hbuild

    steps = [("host library", hbuild.build), ("C ABI", hbuild.build_capi)]
    if device == "cuda":
        steps.append(("kernels K1, K2, K3", kbuild.build))
    times = {}
    for what, fn in steps:
        t0 = time.perf_counter()
        path = fn()
        times[what] = round(time.perf_counter() - t0, 3)
        print(f"[setup] built {what} in {times[what]:.1f} s: {path}",
              flush=True)
    return times


def build_and_decode(device: str) -> dict:
    """Build the libraries (the kernels on ``cuda``) and decode one frame
    against ``core.golden``; raise on any failure."""
    import numpy as np

    from .. import DecodeParams, OutputFormat, api
    from ..core import golden
    from ..kernels import epilogue, transform, wave
    from ..testing import encoder

    times = build_libraries(device)
    blob = encoder.encode_planes(encoder.random_planes("420", 64, 64), "420",
                                 restart_interval=1)
    for mod in (wave, transform, epilogue):
        mod.launches = 0
    dec = api.Decoder(device=device, device_entropy="on")
    img = dec.decode(api.JpegStream(blob), DecodeParams(OutputFormat.RGB))
    want = golden.decode(blob, OutputFormat.RGB)[0][0]
    if not np.array_equal(img.channel[0].cpu().numpy(), want):
        raise AssertionError("the decoded frame differs from core.golden")
    launches = {"wave": wave.launches, "transform": transform.launches,
                "epilogue": epilogue.launches}
    if device == "cuda" and min(launches.values()) < 1:
        raise AssertionError(f"a kernel never launched: {launches}")
    print(f"[setup] decoded one 64x64 4:2:0 frame on {device}, RGB, "
          f"byte-equal to core.golden; kernel launches {launches}",
          flush=True)
    return {"build_s": times, "launches": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where the frame decodes (default cuda)")
    ap.add_argument("--build-only", action="store_true",
                    help="build the libraries (on cuda the kernels too) "
                         "and stop: no card, no decode")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    res = {"ok": False, "device": args.device}
    res["missing"] = check_toolchain(args.device, card=not args.build_only)
    if res["missing"]:
        print(f"[setup] {len(res['missing'])} prerequisite(s) missing: "
              f"{', '.join(res['missing'])}", flush=True)
    elif args.build_only:
        from ..kernels import build as kbuild
        res["build_s"] = build_libraries(args.device)
        res["build_dir"] = kbuild.BUILD_DIR
        res["ok"] = True
    else:
        res.update(build_and_decode(args.device))
        res["ok"] = True
    res["total_s"] = round(time.perf_counter() - t0, 3)
    print(json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
