"""Volume soak of the port: seeded hostile and clean batches through
``Decoder(device="cpu")``, against the JAX package.

The port's counterpart of ``tests/test_soak.py``, over its shape matrix,
restart intervals (DRI=0 included), table variants, optimized tables and
mutations (truncation, bit flips, an embedded marker), drawn by
``rocjpeg_tpu_torch.testing.hostile``. Iteration ``i`` draws its batch from
a generator seeded with ``(SOAK_SEED, i)``, so the sequence is fixed; the
budget, ``ROCJPEG_TPU_TORCH_SOAK_SECS`` (default 30 s, the mirror of the JAX
soak's ``ROCJPEG_TPU_SOAK_SECS``), only cuts how far past
``MIN_ITERATIONS`` it gets, so neither the outcome nor the count of tests
depends on the clock. Iterations alternate ``device_entropy="auto"`` and
``"on"`` (K1's plain version), always with ``check_errors=False``, and
``hostile.check_batch`` holds every batch to the JAX decoder's: the same
parse and decode refusals by status name, the same
``last_failed_indices()``, clean images byte-equal to
``rocjpeg_tpu.core.golden``, and every image no lane flagged byte-equal to
the JAX package's.

``python tests/test_torch_soak.py`` runs it for longer (default 300 s) and
prints the counts as JSON.
"""

import json
import os

import torch

from rocjpeg_tpu import api as japi
from rocjpeg_tpu import types as jtypes
from rocjpeg_tpu.core import golden as jgolden
from rocjpeg_tpu.status import RocJpegError as JaxRocJpegError
from rocjpeg_tpu_torch import api as tapi
from rocjpeg_tpu_torch.status import RocJpegError
from rocjpeg_tpu_torch.testing import hostile
from test_torch_jaxlib import jax_native  # noqa: F401  (autouse)

# The first four iterations of the fixed sequence meet every floor below.
MIN_ITERATIONS = 4


def soak(budget_s: float) -> dict:
    sides = {entropy: (
        (tapi, RocJpegError, tapi.Decoder(device="cpu",
                                          device_entropy=entropy,
                                          check_errors=False)),
        (japi, JaxRocJpegError, japi.Decoder(device_entropy=entropy,
                                             check_errors=False)))
        for entropy in hostile.SOAK_ENTROPY}
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # small tensors: the pool would only spin
    try:
        return hostile.run_soak(
            budget_s, MIN_ITERATIONS, sides,
            lambda blob, fmt: jgolden.decode(blob,
                                             jtypes.OutputFormat(int(fmt))))
    finally:
        torch.set_num_threads(n)


def test_soak_matches_the_jax_package():
    stats = soak(float(os.environ.get("ROCJPEG_TPU_TORCH_SOAK_SECS", "30")))
    # Floors as in tests/test_soak.py, and mixed batches with a flagged
    # image.
    assert stats["iterations"] >= MIN_ITERATIONS
    assert stats["clean"] == stats["clean_exact"] >= 5
    assert stats["mutated"] >= 5
    assert len(stats["configs"]) >= 4
    assert stats["mixed_batches"] >= 1 and stats["failed_images"] >= 1


if __name__ == "__main__":
    print(json.dumps(soak(float(os.environ.get(
        "ROCJPEG_TPU_TORCH_SOAK_SECS", "300")))))
