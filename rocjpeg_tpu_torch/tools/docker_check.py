"""Check the port's Dockerfile without Docker: run its local steps and its
``CMD`` on this machine.

    python -m rocjpeg_tpu_torch.tools.docker_check [--device cpu|cuda]

``tools.install_check`` checks the wheel without an index; this checks
``docker/rocjpeg-tpu-torch-on-ubuntu24.dockerfile`` without Docker or a
network. It parses the file (``FROM``, ``ARG`` defaults, ``ENV``,
``WORKDIR``, ``COPY``, ``RUN``, ``CMD``) and refuses it when:

- the fence line ``# --- local steps: no network below ---`` is missing
  or appears twice;
- below the fence a step reaches a network: ``apt``/``apt-get``, ``curl``,
  ``wget``, ``pip download``, or a ``pip`` command without ``--no-index``
  or a ``pip install`` of anything but a local wheel;
- a local step names an absolute path (every path below the fence is
  relative or comes from an ``ENV``, so the steps run the same under any
  root);
- a ``COPY`` source is not in the checkout;
- an instruction names jax, or the file lacks ``ENV VIRTUAL_ENV`` (the
  image's Python) or ``ENV XDG_CACHE_HOME`` (where the image's build puts
  the libraries), or its ``CMD`` is not ``python3 -m`` a module of the port.

Then it builds the image's file system under a temporary root: every
absolute path of an ``ENV`` or ``WORKDIR`` lies under it. The image's
Python is the ``venv --system-site-packages`` that ``install_check``
makes, at the path ``VIRTUAL_ENV`` names; the steps above the fence
(packages from a network) are not run. Every step below the fence runs in
order, ``RUN`` by ``/bin/sh -c`` with the image's environment, ``COPY``
from the checkout. Then the ``CMD`` runs twice from the image's last
``WORKDIR``; each time the build directory under ``XDG_CACHE_HOME`` must
be left as the image's build left it: the image compiled everything, and
no process compiles again.

With ``--device cuda`` (the default) the image's build step runs nvcc, and
the ``CMD`` (``setup_check``) launches K1, K2 and K3 on the card; the base
image's CUDA version and the PyTorch index's CUDA build are held to this
machine's nvcc and torch. ``--device cpu`` passes ``--device cpu`` to the
``setup_check`` steps, which leaves the nvcc build out and decodes on the
host: an explicit choice, for machines without a card.

Prints one ``[docker]`` line a step with its seconds and the result as
JSON on the last line; exits 1 on any miss. The temporary root is removed
at the end.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import re
import shlex
import shutil
import subprocess
import sys
import tempfile
import time

from ..kernels import build as kbuild
from ..runtime import build as hbuild
from . import install_check

DOCKERFILE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docker",
    "rocjpeg-tpu-torch-on-ubuntu24.dockerfile")
FENCE = "# --- local steps: no network below ---"
INSTRUCTIONS = ("FROM", "ARG", "ENV", "WORKDIR", "COPY", "RUN", "CMD")
NETWORK_COMMANDS = ("apt", "apt-get", "curl", "wget")
# pip options that name somewhere to fetch from.
PIP_SOURCES = ("-r", "--requirement", "-e", "--editable", "-i",
               "--index-url", "--extra-index-url", "-f", "--find-links")
SETUP_CHECK = "rocjpeg_tpu_torch.tools.setup_check"
STEP_TIMEOUT_S = 1800


class DockerCheckError(RuntimeError):
    """The Dockerfile is refused, or one of its steps failed."""


@dataclasses.dataclass
class Instruction:
    line: int    # of the instruction's first line in the file
    op: str      # FROM, ARG, ENV, WORKDIR, COPY, RUN or CMD
    args: str    # the rest, continuation lines joined
    local: bool  # below the fence


def _log(msg: str) -> None:
    print(f"[docker] {msg}", flush=True)


def parse(text: str) -> list:
    """The instructions of ``text`` in order. Raises DockerCheckError for
    an instruction this check does not model or a fence that is missing
    or repeated."""
    out, fences, local = [], 0, False
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        raw = lines[i].strip()
        i += 1
        if raw == FENCE:
            fences += 1
            local = True
            continue
        if not raw or raw.startswith("#"):
            continue
        start, parts = i, [raw]
        while parts[-1].endswith("\\") and i < len(lines):
            parts[-1] = parts[-1][:-1].rstrip()
            nxt = lines[i].strip()
            i += 1
            if not nxt.startswith("#"):
                parts.append(nxt)
        op, _, args = " ".join(parts).partition(" ")
        if op.upper() not in INSTRUCTIONS:
            raise DockerCheckError(f"line {start}: {op} is not modelled "
                                   f"(only {', '.join(INSTRUCTIONS)})")
        out.append(Instruction(start, op.upper(), args.strip(), local))
    if fences != 1:
        raise DockerCheckError(f"the fence line {FENCE!r} appears {fences} "
                               f"times; it must appear once")
    return out


def _exec_form(args: str):
    """The argument list of a JSON-form RUN or CMD, else None."""
    if args.startswith("["):
        try:
            argv = json.loads(args)
        except ValueError as e:
            raise DockerCheckError(f"not a JSON list: {args}") from e
        if not (isinstance(argv, list) and argv
                and all(isinstance(a, str) for a in argv)):
            raise DockerCheckError(f"not a list of strings: {args}")
        return argv
    return None


def _commands(args: str) -> list:
    """The simple commands of a shell-form RUN, each a list of words."""
    lex = shlex.shlex(args, posix=True, punctuation_chars=True)
    lex.whitespace_split = True
    cmds, cur = [], []
    for tok in lex:
        if tok and set(tok) <= set("&|;()"):
            cmds.append(cur)
            cur = []
        else:
            cur.append(tok)
    cmds.append(cur)
    out = []
    for words in cmds:
        while words and re.match(r"^\w+=", words[0]):
            words = words[1:]  # FOO=bar cmd
        if words:
            out.append(words)
    return out


def _network_use(words: list):
    """Why the simple command ``words`` may reach a network, or None."""
    name = os.path.basename(words[0])
    if name in NETWORK_COMMANDS:
        return f"{name} fetches from a network"
    if name in ("pip", "pip3"):
        pip = words[1:]
    elif (name.startswith("python") and len(words) > 2
          and words[1:3] == ["-m", "pip"]):
        pip = words[3:]
    else:
        return None
    sub = next((w for w in pip if not w.startswith("-")), "")
    if sub == "download":
        return "pip download fetches from a network"
    if sub not in ("install", "wheel"):
        return None
    if "--no-index" not in pip:
        return f"pip {sub} without --no-index may reach an index"
    if sub == "install":
        named = [w for w in pip[pip.index(sub) + 1:]
                 if w in PIP_SOURCES or w.split("=")[0] in PIP_SOURCES
                 or not (w.startswith("-") or w.endswith(".whl"))]
        if named:
            return f"pip install of {named}, not of a local wheel"
    return None


def check(instrs: list, root: str) -> None:
    """Refuse the Dockerfile (raise DockerCheckError) unless its local
    steps can need no network and run under any root, every COPY source
    exists in ``root``, and the image has its Python, its build cache and
    a CMD that runs a module of the port."""
    env_keys = set()
    for ins in instrs:
        where = f"line {ins.line}: {ins.op} {ins.args}"
        if "jax" in ins.args.lower():
            raise DockerCheckError(f"{where}: the image installs and "
                                   f"imports nothing of jax")
        if ins.op == "ENV":
            env_keys |= set(_env_pairs(ins.args))
        if ins.op == "COPY":
            srcs, _ = _copy_args(ins.args, where)
            for src in srcs:
                if not os.path.exists(os.path.join(root, src)):
                    raise DockerCheckError(f"{where}: {src} is not in the "
                                           f"checkout {root}")
        if not ins.local:
            if ins.op == "FROM" and not re.match(
                    r"^nvidia/cuda:\S*-devel-", ins.args):
                raise DockerCheckError(f"{where}: the base is not a CUDA "
                                       f"devel image (no nvcc)")
            continue
        if ins.op == "FROM":
            raise DockerCheckError(f"{where}: a second stage below the "
                                   f"fence")
        if ins.op != "RUN":
            continue
        argv = _exec_form(ins.args)
        for words in [argv] if argv else _commands(ins.args):
            why = _network_use(words)
            if why:
                raise DockerCheckError(f"{where}: below the fence {why}")
            absolute = [w for w in words[1:] if w.startswith("/")]
            if absolute:
                raise DockerCheckError(f"{where}: a local step names the "
                                       f"absolute path(s) {absolute}")
    for key in ("VIRTUAL_ENV", "XDG_CACHE_HOME"):
        if key not in env_keys:
            raise DockerCheckError(f"no ENV {key}")
    cmd = [ins for ins in instrs if ins.op == "CMD"]
    if len(cmd) != 1:
        raise DockerCheckError(f"{len(cmd)} CMD instructions; want one")
    argv = _exec_form(cmd[0].args) or []
    if (len(argv) < 3 or argv[:2] != ["python3", "-m"]
            or not argv[2].startswith("rocjpeg_tpu_torch.")
            or importlib.util.find_spec(argv[2]) is None):
        raise DockerCheckError(f"line {cmd[0].line}: the CMD {cmd[0].args} "
                               f"is not python3 -m a module of the port")


def _env_pairs(args: str) -> dict:
    """``ENV K=V [K2=V2 ...]`` or ``ENV K V``."""
    words = shlex.split(args)
    if words and "=" not in words[0]:
        return {words[0]: " ".join(words[1:])}
    return dict(w.split("=", 1) for w in words)


def _copy_args(args: str, where: str) -> tuple:
    words = shlex.split(args)
    if not words or words[0].startswith("--") or len(words) < 2:
        raise DockerCheckError(f"{where}: only COPY <src>... <dest>")
    return words[:-1], words[-1]


def _arg_default(ins: Instruction):
    """(name, default) of an ``ARG name=default``, else None."""
    if ins.op != "ARG" or "=" not in ins.args:
        return None
    key, value = ins.args.split("=", 1)
    return key.strip(), value.strip()


def _expand(text: str, env: dict) -> str:
    return re.sub(r"\$(?:\{(\w+)\}|(\w+))",
                  lambda m: env.get(m.group(1) or m.group(2), ""), text)


class _Image:
    """The image's file system under ``root`` and its environment."""

    def __init__(self, root: str, base_env: dict):
        self.root = root
        self.env = {}        # the image's ENV, paths under root
        self.args = {}       # ARG defaults of the stage
        self.base_env = base_env
        self.cwd = root
        self.python_site = None

    def path(self, p: str) -> str:
        """An image path on this machine: absolute ones under the root."""
        return self.root + p if p.startswith("/") else os.path.join(
            self.cwd, p)

    def environ(self, with_args: bool = False) -> dict:
        env = dict(self.base_env, **self.env)
        return dict(env, **self.args) if with_args else env

    def set_env(self, args: str) -> None:
        for key, value in _env_pairs(args).items():
            items = [self.root + item if item.startswith("/")
                     and not item.startswith("//") else item
                     for item in value.split(":")]
            self.env[key] = _expand(":".join(items), self.environ())
            if key == "VIRTUAL_ENV":
                _, self.python_site = install_check.make_venv(
                    self.env[key], DockerCheckError)

    def workdir(self, args: str) -> None:
        self.cwd = self.path(_expand(args, self.environ()))
        os.makedirs(self.cwd, exist_ok=True)

    def copy(self, args: str, context: str) -> None:
        srcs, dest = _copy_args(args, f"COPY {args}")
        to_dir = dest.endswith("/") or len(srcs) > 1
        dest = self.path(dest)
        for src in srcs:
            path = os.path.join(context, src)
            if os.path.isdir(path):
                os.makedirs(dest, exist_ok=True)
                install_check.copy_source(path, dest,
                                          sorted(os.listdir(path)))
            elif to_dir:
                os.makedirs(dest, exist_ok=True)
                install_check.copy_source(context, dest, [src])
            else:
                shutil.copy(path, dest)

    def run(self, argv: list,
            with_args: bool = False) -> subprocess.CompletedProcess:
        """``argv`` in the image's working directory and environment (and
        the stage's ARGs, as a RUN has them)."""
        return install_check.run_checked(
            argv, DockerCheckError, cwd=self.cwd,
            env=self.environ(with_args), timeout=STEP_TIMEOUT_S)


def _for_device(argv: list, device: str) -> list:
    """``--device cpu`` appended to a setup_check command on the CPU."""
    if device == "cpu" and any(SETUP_CHECK in a for a in argv):
        return [*argv, "--device", "cpu"]
    return argv


def _kind(ins: Instruction) -> str:
    if ins.op != "RUN":
        return ins.op.lower()
    if re.search(r"\bpip wheel\b", ins.args):
        return "wheel"
    if re.search(r"\bpip install\b", ins.args):
        return "install"
    if SETUP_CHECK in ins.args:
        return "prebuild"
    return "run"


def _snapshot(path: str) -> dict:
    """Every file under ``path``: its size and modification time."""
    found = {}
    for base, _dirs, names in os.walk(path):
        for n in names:
            st = os.stat(os.path.join(base, n))
            found[os.path.relpath(os.path.join(base, n), path)] = (
                st.st_size, st.st_mtime_ns)
    return found


def _changed(before: dict, after: dict) -> list:
    return sorted(k for k, v in after.items() if before.get(k) != v)


def _held_to_this_machine(instrs: list) -> dict:
    """On the card: the base image's CUDA version against this machine's
    nvcc release, and the PyTorch index's CUDA build against its torch."""
    import torch
    args = dict(filter(None, map(_arg_default, instrs)))
    out = subprocess.run([kbuild._nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    release = re.search(r"release (\d+\.\d+)", out).group(1)
    base = args.get("CUDA_VERSION", "")
    if ".".join(base.split(".")[:2]) != release:
        raise DockerCheckError(f"ARG CUDA_VERSION={base}, but this "
                               f"machine's nvcc is release {release}")
    index = args.get("TORCH_INDEX_URL", "")
    want = "cu" + (torch.version.cuda or "").replace(".", "")
    if not index.rstrip("/").endswith("/" + want):
        raise DockerCheckError(f"ARG TORCH_INDEX_URL={index}, but this "
                               f"machine's torch is built for {want}")
    return {"CUDA_VERSION": base, "nvcc_release": release,
            "TORCH_INDEX_URL": index, "torch": torch.__version__}


def run(device: str = "cuda", dockerfile: str | None = None) -> dict:
    """Check ``dockerfile`` (the port's, by default) and run its local
    steps and its CMD twice over the checkout that holds this package;
    return the results, or raise DockerCheckError."""
    dockerfile = dockerfile or DOCKERFILE
    context = kbuild.checkout_root()
    if context is None:
        raise DockerCheckError("the package is not in a source checkout")
    t_all = time.perf_counter()
    with open(dockerfile) as f:
        instrs = parse(f.read())
    check(instrs, context)
    res = {"device": device, "dockerfile": os.path.relpath(dockerfile,
                                                           context)}
    _log(f"parsed {res['dockerfile']}: {len(instrs)} instructions, "
         f"{sum(i.local for i in instrs)} below the fence; no network "
         f"command below it, every COPY source in the checkout")
    if device == "cuda":
        res["held"] = _held_to_this_machine(instrs)
        _log(f"base CUDA {res['held']['CUDA_VERSION']} matches this "
             f"machine's nvcc release {res['held']['nvcc_release']}; "
             f"{res['held']['TORCH_INDEX_URL']} matches torch "
             f"{res['held']['torch']}")
    tmp = tempfile.mkdtemp(prefix="rjt_docker_")
    try:
        image = _Image(os.path.join(tmp, "image"), install_check.clean_env())
        os.makedirs(image.root)
        steps, seconds = [], {}
        for n, ins in enumerate(instrs, 1):
            what = f"{n}. line {ins.line}: {ins.op} {ins.args}"
            if ins.op == "FROM":
                image.args = {}  # ARGs before FROM serve FROM alone
                _log(f"{what}: the base, not pulled")
                continue
            if _arg_default(ins):
                image.args.update([_arg_default(ins)])
            if ins.op in ("ARG", "CMD"):
                continue
            if not ins.local and ins.op in ("RUN", "COPY"):
                _log(f"{what}: above the fence, not run")
                continue
            t0 = time.perf_counter()
            if ins.op == "ENV":
                image.set_env(ins.args)
            elif ins.op == "WORKDIR":
                image.workdir(ins.args)
            elif ins.op == "COPY":
                image.copy(ins.args, context)
            else:
                argv = _exec_form(ins.args)
                proc = image.run(_for_device(argv, device) if argv else [
                    "/bin/sh", "-c",
                    " ".join(_for_device([ins.args], device))],
                    with_args=True)
            sec = round(time.perf_counter() - t0, 3)
            kind = _kind(ins)
            if kind == "prebuild":  # setup_check --build-only's result
                res["prebuild_s"] = json.loads(
                    proc.stdout.strip().splitlines()[-1])["build_s"]
                what += f": {res['prebuild_s']} s"
            seconds[kind] = round(seconds.get(kind, 0.0) + sec, 3)
            steps.append({"line": ins.line, "op": ins.op, "kind": kind,
                          "s": sec})
            _log(f"{what} ({sec:.1f} s)")
        res["steps"], res["seconds"] = steps, seconds
        if image.python_site is None:
            raise DockerCheckError("no ENV VIRTUAL_ENV above the steps")
        res["cache"] = os.path.relpath(os.path.join(
            image.env["XDG_CACHE_HOME"], "rocjpeg_tpu_torch"), image.root)
        _check_image(image, device, res)
        _run_cmd(image, instrs, device, res)
        res["total_s"] = round(time.perf_counter() - t_all, 3)
        res["ok"] = True
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _check_image(image: _Image, device: str, res: dict) -> None:
    """The package resolves in the image's site-packages, and the image's
    build put the libraries of these sources under its XDG_CACHE_HOME."""
    got = image.run(["python3", "-c", "import os, rocjpeg_tpu_torch; print("
                     "os.path.dirname(os.path.dirname("
                     "rocjpeg_tpu_torch.__file__)))"])
    site = got.stdout.strip()
    if os.path.realpath(site) != os.path.realpath(image.python_site):
        raise DockerCheckError(f"rocjpeg_tpu_torch resolves in {site}, not "
                               f"in the image's {image.python_site}")
    cache = os.path.join(image.root, res["cache"])
    built = sorted(os.listdir(cache)) if os.path.isdir(cache) else []
    want = [os.path.basename(hbuild.library_path())]
    if device == "cuda":
        want.append(os.path.basename(kbuild.library_path()))
    missing = [w for w in want if w not in built]
    if missing or not any(n.startswith("capi_") for n in built):
        raise DockerCheckError(f"the image's build left {built} in {cache}; "
                               f"missing {missing or 'the C ABI'}")
    res["libraries"] = [n for n in built if not n.endswith(".txt")]
    _log(f"the package resolves in the image's site-packages; /"
         f"{res['cache']} holds {', '.join(res['libraries'])}")


def _run_cmd(image: _Image, instrs: list, device: str, res: dict) -> None:
    """The CMD twice, from the image's last WORKDIR; neither may compile."""
    (cmd,) = [ins for ins in instrs if ins.op == "CMD"]
    argv = _for_device(_exec_form(cmd.args), device)
    cache = os.path.join(image.root, res["cache"])
    res["cmd"] = []
    for n in (1, 2):
        before = _snapshot(cache)
        t0 = time.perf_counter()
        proc = image.run(argv)
        sec = round(time.perf_counter() - t0, 3)
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        compiled = _changed(before, _snapshot(cache))
        decoded = [line for line in proc.stdout.splitlines()
                   if "byte-equal to core.golden" in line]
        res["cmd"].append({"s": sec, "launches": out.get("launches"),
                           "compiled": len(compiled), "decoded": decoded})
        _log(f"CMD {' '.join(argv)} #{n}: exit 0 in {sec:.1f} s; "
             f"{decoded[0].removeprefix('[setup] ') if decoded else '?'}; "
             f"compiled {len(compiled)} file(s)")
        if not out.get("ok") or not decoded:
            raise DockerCheckError(f"CMD #{n} did not decode: "
                                   f"{proc.stdout}")
        if device == "cuda" and min(out["launches"].values()) < 1:
            raise DockerCheckError(f"CMD #{n}: a kernel never launched: "
                                   f"{out['launches']}")
        if compiled:
            raise DockerCheckError(f"CMD #{n} compiled {compiled} in "
                                   f"{cache}: the image's build left it "
                                   f"to the container")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where the image's CMD decodes; cpu also leaves "
                         "the nvcc build out (default cuda)")
    args = ap.parse_args(argv)
    try:
        res = run(args.device)
    except (DockerCheckError, subprocess.TimeoutExpired) as e:
        print(f"docker check FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
