"""The CMake build of the port's host library, for C consumers.

``rocjpeg_tpu_torch/csrc/host/CMakeLists.txt`` builds into the caller's
build directory and installs into the caller's prefix, with the flags of
``runtime.build.GXX_FLAGS``; it writes nothing into the package. Loaded
through ``ROCJPEG_TPU_TORCH_HOST_LIB``, its library decodes byte for byte
as the package's own g++ build does.
"""

import os
import subprocess
import sys
import textwrap

from rocjpeg_tpu_torch.runtime import build, native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = os.path.join(ROOT, "rocjpeg_tpu_torch", "csrc", "host")

# Decodes a few frames through the native parse and entropy decode (the
# host path) and prints a digest of every output and the loaded library.
DECODE = textwrap.dedent("""
    import hashlib
    from rocjpeg_tpu_torch import DecodeParams, OutputFormat, api
    from rocjpeg_tpu_torch.runtime import native
    from rocjpeg_tpu_torch.testing import encoder
    h = hashlib.sha256()
    dec = api.Decoder(device="cpu", device_entropy="off")
    for css in ("420", "422", "444"):
        for ri in (0, 2):
            blob = encoder.encode_planes(encoder.random_planes(css, 96, 64),
                                         css, restart_interval=ri)
            for fmt in (OutputFormat.NATIVE, OutputFormat.RGB):
                img = dec.decode(api.JpegStream(blob), DecodeParams(fmt))
                for ch in img.channel:
                    if ch is not None:
                        h.update(ch.numpy().tobytes())
    maps = open("/proc/self/maps").read()
    print(h.hexdigest(), native.library_file() in maps,
          native.library_file())
""")


def _decode(library=None):
    env = dict(os.environ)
    env.pop(native.HOST_LIB_ENV, None)
    if library:
        env[native.HOST_LIB_ENV] = library
    proc = subprocess.run([sys.executable, "-c", DECODE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.split()


def test_cmake_build_decodes_as_the_gxx_build(tmp_path):
    before = sorted(os.listdir(HOST))
    bdir, prefix = tmp_path / "build", tmp_path / "prefix"
    for cmd in (["cmake", "-S", HOST, "-B", str(bdir)],
                ["cmake", "--build", str(bdir), "--verbose"],
                ["cmake", "--install", str(bdir), "--prefix", str(prefix)]):
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        if "--build" in cmd:
            compile_line = next(line for line in proc.stdout.splitlines()
                                if "rocjpeg_entropy.cpp" in line
                                and " -c " in line)
    for flag in build.GXX_FLAGS:
        if flag != "-shared":  # a link flag
            assert flag in compile_line.split(), flag
    lib = prefix / "lib" / "librjt_host.so"
    assert sorted(p.name for p in prefix.rglob("*") if p.is_file()) == [
        lib.name]
    assert sorted(os.listdir(HOST)) == before  # nothing written there
    digest, mapped, path = _decode(str(lib))
    assert mapped == "True" and path == str(lib)
    want, mapped, path = _decode()
    assert path == build.build() and mapped == "True"
    assert digest == want
