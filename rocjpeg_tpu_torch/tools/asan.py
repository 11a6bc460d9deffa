"""Run host-library test suites under AddressSanitizer.

    python -m rocjpeg_tpu_torch.tools.asan [pytest arguments]

The counterpart of the JAX package's ``make test-asan``. Builds the
``-fsanitize=address`` variant of the port's host library
(``runtime.build.build(asan=True)``) and runs ``python -m pytest`` in a
process that has the AddressSanitizer runtime preloaded
(``LD_PRELOAD=<libasan>``), loads the variant through
``ROCJPEG_TPU_TORCH_HOST_LIB`` and keeps the leak check off
(``ASAN_OPTIONS=detect_leaks=0``: CPython leaks on purpose at exit).

With no arguments it runs ``tests/test_torch_native_fuzz.py`` and
``tests/test_torch_hostlayer.py`` of the checkout: the port's native fuzz
and its host layer against the JAX package's, which drive every entry
point of the host library. It leaves out the suites that execute XLA
programs (the JAX package's pipeline, the port's parity tests of the
device path): jaxlib's statically linked C++ runtime trips the
sanitizer's ``__cxa_throw`` interceptor, as the JAX package's Makefile
notes beside its own ``test-asan``.

Exits with pytest's code, or 1 when pytest passed but the process's
standard error holds an ``ERROR: AddressSanitizer`` report.
"""

from __future__ import annotations

import os
import subprocess
import sys

from ..kernels.build import checkout_root
from ..runtime import build
from ..runtime.native import HOST_LIB_ENV

DEFAULT_SUITES = ("tests/test_torch_native_fuzz.py",
                  "tests/test_torch_hostlayer.py")
REPORT = "ERROR: AddressSanitizer"


def asan_env(library: str) -> dict:
    """This process's environment, for a process that runs ``library``
    (the ASAN build) under the preloaded sanitizer runtime."""
    env = dict(os.environ)
    env.update(LD_PRELOAD=build.libasan_path(),
               ASAN_OPTIONS="detect_leaks=0", JAX_PLATFORMS="cpu")
    env[HOST_LIB_ENV] = library
    return env


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    root = checkout_root()
    if not args:
        if root is None:
            print("asan: no source checkout; name the test files",
                  file=sys.stderr)
            return 2
        args = [os.path.join(root, s) for s in DEFAULT_SUITES] + ["-q"]
    library = build.build(asan=True)
    print(f"asan: {library} under {build.libasan_path()}", flush=True)
    proc = subprocess.Popen([sys.executable, "-m", "pytest", *args],
                            env=asan_env(library), cwd=root,
                            stderr=subprocess.PIPE, text=True,
                            errors="replace")
    reported = False
    for line in proc.stderr:
        sys.stderr.write(line)
        reported = reported or REPORT in line
    rc = proc.wait()
    if reported and rc == 0:
        print(f"asan: pytest passed but stderr holds {REPORT!r}",
              file=sys.stderr)
        return 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
