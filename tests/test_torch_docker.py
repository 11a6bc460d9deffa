"""The port's Dockerfile and its check without Docker.

``rocjpeg_tpu_torch/docker/rocjpeg-tpu-torch-on-ubuntu24.dockerfile`` keeps
every step that needs a network above a fixed fence line; the steps below
it are local commands that ``tools.docker_check`` runs on this machine
under a temporary root: the wheel, its install with ``--no-deps``, and the
image's build of the libraries into its ``XDG_CACHE_HOME``. Then the image's
``CMD`` runs twice and compiles nothing. The three sample CLIs on the
image's ``PATH`` run the port's tools, with jax refused in their process
(the wheel's own console scripts name the JAX package's tools, which fail
at ``import jax`` in an image without JAX). On the CPU the check passes
``--device cpu`` to the ``setup_check`` steps, by that explicit flag, which
leaves the nvcc build out.
"""

import json
import os
import re

import pytest

from rocjpeg_tpu_torch.kernels import build as kbuild
from rocjpeg_tpu_torch.runtime import build as hbuild
from rocjpeg_tpu_torch.tools import docker_check, setup_check

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def text():
    with open(docker_check.DOCKERFILE) as f:
        return f.read()


@pytest.fixture(scope="module")
def instrs(text):
    return docker_check.parse(text)


@pytest.fixture(scope="module")
def cpu_run():
    """The whole check on the CPU, once for the module (about 25 s)."""
    return docker_check.run("cpu")


def test_dockerfile_passes_its_check(instrs):
    docker_check.check(instrs, ROOT)


def test_fence_splits_network_steps_from_local_ones(text, instrs):
    assert [line.strip() for line in text.splitlines()].count(
        docker_check.FENCE) == 1
    above = [i for i in instrs if not i.local]
    below = [i for i in instrs if i.local]
    assert above and below
    network = [i for i in above if i.op == "RUN" and re.search(
        r"apt-get|pip install", i.args)]
    assert len(network) == 2  # apt-get, then torch from its index
    for ins in below:
        if ins.op == "RUN":
            for words in docker_check._commands(ins.args):
                assert docker_check._network_use(words) is None, ins


def test_base_image_and_its_arguments(instrs):
    args = dict(i.args.split("=", 1) for i in instrs if i.op == "ARG")
    (base,) = [i.args for i in instrs if i.op == "FROM"]
    assert base == "nvidia/cuda:${CUDA_VERSION}-devel-ubuntu24.04"
    major, minor = (int(x) for x in args["CUDA_VERSION"].split(".")[:2])
    assert (major, minor) >= (12, 0)  # nvcc targets sm_90a
    assert re.fullmatch(r"https://download\.pytorch\.org/whl/cu\d+",
                        args["TORCH_INDEX_URL"])


def test_copy_sources_exist_and_env_names_the_cache(instrs):
    copies = [i for i in instrs if i.op == "COPY"]
    assert copies and all(i.local for i in copies)
    for ins in copies:
        srcs, _dest = docker_check._copy_args(ins.args, ins.args)
        for src in srcs:
            assert os.path.exists(os.path.join(ROOT, src)), src
    env = {}
    for ins in instrs:
        if ins.op == "ENV":
            env.update(docker_check._env_pairs(ins.args))
    assert env["XDG_CACHE_HOME"].startswith("/opt/")
    assert env["VIRTUAL_ENV"] == "/opt/venv"


def test_no_instruction_names_jax(instrs):
    for ins in instrs:
        assert "jax" not in ins.args.lower(), ins


def test_cmd_runs_a_module_of_the_port(instrs):
    import importlib.util
    (cmd,) = [i for i in instrs if i.op == "CMD"]
    argv = json.loads(cmd.args)
    assert argv == ["python3", "-m", "rocjpeg_tpu_torch.tools.setup_check"]
    assert importlib.util.find_spec(argv[2]) is not None


PREBUILD = ("RUN python3 -m rocjpeg_tpu_torch.tools.setup_check "
            "--build-only\n")


def _below_fence(text, line):
    return text.replace(docker_check.FENCE, docker_check.FENCE + "\n" + line)


REFUSED = {
    "pip-install-below-the-fence": (
        lambda t: _below_fence(t, "RUN python3 -m pip install --no-index "
                                  "numpy"), "not of a local wheel"),
    "pip-without-no-index": (
        lambda t: _below_fence(t, "RUN python3 -m pip install x.whl"),
        "without --no-index"),
    "pip-index-url": (
        lambda t: _below_fence(t, "RUN pip install --no-index -i "
                                  "https://example.invalid x.whl"),
        "not of a local wheel"),
    "pip-download": (
        lambda t: _below_fence(t, "RUN pip download --no-index x"),
        "pip download"),
    "apt-get-below-the-fence": (
        lambda t: _below_fence(t, "RUN true && apt-get install -y g++"),
        "apt-get fetches"),
    "curl-below-the-fence": (
        lambda t: _below_fence(t, "RUN curl -sO https://example.invalid/x"),
        "curl fetches"),
    "wget-below-the-fence": (
        lambda t: _below_fence(t, "RUN cd src; wget https://example.invalid"),
        "wget fetches"),
    "missing-copy-source": (
        lambda t: t.replace("COPY pyproject.toml README.md ./",
                            "COPY pyproject.toml NO_SUCH_FILE.md ./"),
        "NO_SUCH_FILE.md is not in the checkout"),
    "absolute-path-below-the-fence": (
        lambda t: _below_fence(t, "RUN ls /opt"), "absolute path"),
    "no-fence": (
        lambda t: t.replace(docker_check.FENCE, "# local steps"),
        "appears 0 times"),
    "two-fences": (
        lambda t: _below_fence(t, docker_check.FENCE), "appears 2 times"),
    "jax": (
        lambda t: t.replace("numpy setuptools", "numpy jax setuptools"),
        "nothing of jax"),
    "no-cache-env": (
        lambda t: re.sub(r"ENV XDG_CACHE_HOME=\S+", "ENV CACHE=/opt/c", t),
        "no ENV XDG_CACHE_HOME"),
    "cmd-outside-the-port": (
        lambda t: t.replace('"rocjpeg_tpu_torch.tools.setup_check"]',
                            '"json.tool"]'), "not python3 -m a module"),
    "unmodelled-instruction": (
        lambda t: _below_fence(t, "ADD https://example.invalid/x.tgz ."),
        "ADD is not modelled"),
    "base-without-nvcc": (
        lambda t: t.replace("-devel-ubuntu24.04", "-runtime-ubuntu24.04"),
        "not a CUDA devel image"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_check_refuses(text, case):
    edit, message = REFUSED[case]
    with pytest.raises(docker_check.DockerCheckError, match=re.escape(
            message)):
        docker_check.check(docker_check.parse(edit(text)), ROOT)


@pytest.mark.parametrize("case", ["pip-install-below-the-fence",
                                  "missing-copy-source"])
def test_run_refuses_before_running_anything(text, tmp_path, case,
                                              monkeypatch, capsys):
    edit, message = REFUSED[case]
    path = tmp_path / "broken.dockerfile"
    path.write_text(edit(text))
    with pytest.raises(docker_check.DockerCheckError, match=re.escape(
            message)):
        docker_check.run("cpu", str(path))
    monkeypatch.setattr(docker_check, "DOCKERFILE", str(path))
    assert docker_check.main(["--device", "cpu"]) == 1
    captured = capsys.readouterr()
    assert "docker check FAILED" in captured.err
    assert not re.search(r"\[docker\] \d+\. line", captured.out)  # no step


def test_device_flag_reaches_only_setup_check():
    cpu = ["--device", "cpu"]
    assert docker_check._for_device(["python3", "-m", docker_check.
                                     SETUP_CHECK], "cpu")[-2:] == cpu
    assert docker_check._for_device(["python3", "-m", "pip"], "cpu")[-2:] \
        != cpu
    assert docker_check._for_device(
        [f"python3 -m {docker_check.SETUP_CHECK} --build-only"], "cuda") == [
        f"python3 -m {docker_check.SETUP_CHECK} --build-only"]


def test_local_steps_and_cmd_run_on_the_cpu(cpu_run):
    res = cpu_run
    assert res["ok"] and res["device"] == "cpu"
    kinds = [s["kind"] for s in res["steps"] if s["op"] == "RUN"]
    assert kinds == ["wheel", "install", "scripts", "prebuild"]
    assert [s["op"] for s in res["steps"]].count("COPY") == 3
    assert set(res["prebuild_s"]) == {"host library", "C ABI"}  # no nvcc
    assert "held" not in res  # no nvcc or CUDA torch to hold it to
    for cmd in res["cmd"]:
        assert len(cmd["decoded"]) == 1
        assert "byte-equal to core.golden" in cmd["decoded"][0]
        assert cmd["launches"] == {"wave": 0, "transform": 0,
                                   "epilogue": 0}


def test_image_build_leaves_the_libraries_in_its_cache(cpu_run):
    assert cpu_run["cache"] == os.path.join(
        "opt", "rocjpeg_tpu_torch", "cache", "rocjpeg_tpu_torch")
    libs = cpu_run["libraries"]
    assert os.path.basename(hbuild.library_path()) in libs
    assert any(n.startswith("capi_") for n in libs)
    assert not any(n.startswith("librjt_kernels_") for n in libs)


def test_image_scripts_run_the_ports_tools_without_jax(cpu_run):
    assert sorted(cpu_run["scripts"]) == sorted(docker_check.SCRIPTS)
    for tool, got in cpu_run["scripts"].items():
        assert got["runs"] == f"rocjpeg_tpu_torch.tools.{tool}"


@pytest.mark.parametrize("image_path, want", [
    (None, "/refuse"),
    ("/opt/extra", os.pathsep.join(["/refuse", "/opt/extra"])),
])
def test_scripts_keep_the_images_pythonpath(image_path, want):
    """The scripts run under the image's own ``PYTHONPATH``, with the
    refusing ``sitecustomize`` put first, not in its place."""
    env = {"PATH": "/bin"}
    if image_path:
        env["PYTHONPATH"] = image_path
    got = docker_check._refusing_env(env, "/refuse")
    assert got == dict(env, PYTHONPATH=want)


SCRIPTS_STEP = re.compile(r"^RUN for tool in jpegdecode .*?done\n",
                          re.M | re.S)


def test_wheel_scripts_without_the_repair_are_refused(text, tmp_path):
    """Without the step that points them at the port, the scripts on the
    image's PATH are the wheel's, which run the JAX package's tools: with
    jax refused, ``jpegdecode -h`` dies at its first import."""
    assert len(SCRIPTS_STEP.findall(text)) == 1
    path = tmp_path / "wheel-scripts.dockerfile"
    path.write_text(SCRIPTS_STEP.sub("", text))
    with pytest.raises(docker_check.DockerCheckError,
                       match=r"jpegdecode on the image's PATH runs "
                             r"rocjpeg_tpu\.tools\.jpegdecode\.main; "
                             r"`jpegdecode -h` without jax exited 1: "
                             r".*refused in this process"):
        docker_check.run("cpu", str(path))


def test_no_cmd_process_compiles(cpu_run):
    assert [c["compiled"] for c in cpu_run["cmd"]] == [0, 0]


def test_image_without_its_build_step_is_refused(text, tmp_path):
    path = tmp_path / "no-prebuild.dockerfile"
    path.write_text(text.replace(PREBUILD, ""))
    with pytest.raises(docker_check.DockerCheckError,
                       match="missing.*librjt_host_"):
        docker_check.run("cpu", str(path))


def test_cmd_that_compiles_is_refused(text, tmp_path, monkeypatch):
    """Without the image's build step the CMD builds the host library and
    the C ABI itself, and the check says so (with the library check that
    would have caught it first turned off)."""
    path = tmp_path / "no-prebuild.dockerfile"
    path.write_text(text.replace(PREBUILD, ""))
    monkeypatch.setattr(docker_check, "_check_image", lambda *a: None)
    with pytest.raises(docker_check.DockerCheckError,
                       match=r"CMD #1 compiled .*librjt_host_.*left it to "
                             r"the container"):
        docker_check.run("cpu", str(path))


def test_build_only_checks_no_card(capsys):
    """The image's build step needs the compilers, not a card."""
    missing = setup_check.check_toolchain("cuda", card=False)
    out = capsys.readouterr().out
    assert "card" not in missing and "driver" not in missing
    assert "compute capability" not in out
    assert setup_check.main(["--device", "cpu", "--build-only"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    res = json.loads(lines[-1])
    assert res["ok"] and set(res["build_s"]) == {"host library", "C ABI"}
    assert res["build_dir"] == kbuild.BUILD_DIR
    assert not any("decoded" in line for line in lines)


def test_kernel_build_returns_the_path_without_loading(monkeypatch,
                                                        tmp_path):
    made = []

    def fake_build(out, defines=()):
        made.append(out)
        open(out, "w").close()

    monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kbuild, "_build", fake_build)
    monkeypatch.setattr(kbuild.ctypes, "CDLL", None)  # never loaded
    path = kbuild.build()
    assert path == kbuild.library_path() and made == [path]
    assert kbuild.build() == path and made == [path]  # built once
