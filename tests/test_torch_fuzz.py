"""Hostile streams through the port's public API, against the JAX package.

The port's counterpart of ``tests/test_fuzz.py``: its truncation sweep (the
same cut points), its 24 seeded bit-flip mutations and its six garbage blobs
go through ``Decoder(device="cpu")`` and through the JAX ``api.Decoder``.
Every failure must be a ``RocJpegError`` (the reference's whole-API
contract), with the JAX package's ``Status`` name; where both decode, the
bytes must be equal. Each blob runs under ``device_entropy="auto"`` (96x64
with restart interval 2 is 12 lanes, so the host path), ``"on"`` (K1's
plain version, which raises ``BAD_JPEG`` on a flagged lane), and ``"on"``
with ``check_errors=False``, where the failed indices must match and the
bytes of an image no lane flagged must too (on a flagged lane the two
packages write different garbage, ``ROADMAP.md`` §3). The JAX wave that runs
on the CPU is its jnp wave, where K1 follows its Pallas kernel; the two
differ only on a table slot outside the bank, and every blob here gives the
jnp wave's outcome, so none needs the Pallas kernel's interpreter.
"""

import pytest
import torch

from rocjpeg_tpu import api as japi
from rocjpeg_tpu.testing import encoder as jencoder
from rocjpeg_tpu.status import RocJpegError as JaxRocJpegError
from rocjpeg_tpu_torch import api as tapi
from rocjpeg_tpu_torch.status import RocJpegError
from rocjpeg_tpu_torch.testing import hostile
from rocjpeg_tpu_torch.types import OutputFormat
from test_torch_jaxlib import jax_native  # noqa: F401  (autouse)

BLOBS = ([("trunc", k) for k in range(hostile.N_CUTS)]
         + [("bitflip", k) for k in range(hostile.N_FLIPS)]
         + [("garbage", k) for k in range(hostile.N_GARBAGE)])
MODES = {"auto": ("auto", True), "on": ("on", True),
         "on-unchecked": ("on", False)}
RGB = OutputFormat.RGB


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """K1's plain version steps over small tensors: torch's intra-op pool
    only spins there, against the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def blobs():
    by_kind = {}
    for kind, blob in hostile.fuzz_blobs():
        by_kind.setdefault(kind, []).append(blob)
    return by_kind


def sides(mode):
    """The JAX package's side and the port's, as ``hostile.outcome`` takes
    them."""
    entropy, check = MODES[mode]
    return ((japi, JaxRocJpegError,
             japi.Decoder(device_entropy=entropy, check_errors=check)),
            (tapi, RocJpegError,
             tapi.Decoder(device="cpu", device_entropy=entropy,
                          check_errors=check)))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind, k", BLOBS, ids=[f"{a}{b}" for a, b in BLOBS])
def test_hostile_blob_as_the_jax_package(blobs, mode, kind, k):
    blob = blobs[kind][k]
    jax_side, port_side = sides(mode)
    mine = hostile.outcome(port_side, blob, RGB)
    assert mine == hostile.outcome(jax_side, blob, RGB)
    if mode == "on-unchecked" and mine[0] == "decoded":
        assert mine[1] in ([], [0])


def test_the_sweep_reaches_the_wave_and_its_refusals(blobs):
    """The sweep is not all header refusals: on the wave, some blobs decode
    and some are refused for a corrupt scan after parsing."""
    _, port_side = sides("on-unchecked")
    flagged = decoded = 0
    for blob in blobs["bitflip"]:
        got = hostile.outcome(port_side, blob, RGB)
        if got[0] == "decoded":
            decoded += 1
            flagged += bool(got[1])
    assert decoded >= 5 and flagged >= 1


def test_the_base_image_is_the_jax_suites():
    assert hostile.fuzz_base() == jencoder.encode_planes(
        jencoder.random_planes("420", 96, 64, seed=3), "420",
        restart_interval=2)
