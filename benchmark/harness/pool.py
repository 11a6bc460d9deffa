"""The benchmark's worker processes: they encode the corpus before the
window and run the reference after it, never during it.

Workers are spawned (the parent holds CUDA and threads), import NumPy and
the benchmark's own modules only, and run one BLAS thread each.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os

_ONE_THREAD = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def workers() -> int:
    return max(1, min(8, os.cpu_count() or 1))


@contextlib.contextmanager
def pool(n: int = 0):
    """A started pool of ``n`` (default :func:`workers`) spawned
    processes, closed and joined on exit."""
    saved = {k: os.environ.get(k) for k in _ONE_THREAD}
    os.environ.update(dict.fromkeys(_ONE_THREAD, "1"))
    try:
        p = multiprocessing.get_context("spawn").Pool(n or workers())
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    try:
        yield p
    except BaseException:
        p.terminate()
        p.join()
        raise
    p.close()
    p.join()
