"""Hostile bytes through the port's own native bindings, against the JAX
package's.

The port's counterpart of ``tests/test_native_fuzz.py``: its truncation
sweep, bit flips, garbage headers and hostile Huffman tables go through the
port's ``runtime/native.py`` (``parse_header``, ``decode_scan``,
``seg_lens`` with ``pack_dense``, ``index_scan``) and through
``rocjpeg_tpu.runtime.native`` on the same bytes. Every call must give the
same outcome in both: the same ``Status`` name and code, or the same arrays.
The port has no ``pack_rows``: its packer does not use it. Each sweep runs
on the JAX suite's base image (restart interval 3) and on the same image
without restart markers, whose scan the index walk of virtual restarts
reads.
"""

import dataclasses

import numpy as np
import pytest

from rocjpeg_tpu.core.bitstream import JpegStreamParams as JaxParams
from rocjpeg_tpu.status import RocJpegError as JaxRocJpegError
from rocjpeg_tpu_torch.runtime import native
from rocjpeg_tpu_torch.status import RocJpegError
from rocjpeg_tpu_torch.testing import encoder
from test_torch_jaxlib import jax_native  # noqa: F401  (autouse)

MAX_SEGS = 1 << 12
INDEX_SYMBOLS = 40
BASES = {"ri3": 3, "ri0": 0}


def base_blob(ri: int) -> bytes:
    """``tests/test_native_fuzz.py``'s base image, at restart interval
    ``ri``."""
    return encoder.encode_planes(
        encoder.random_planes("420", 136, 104, seed=77), "420",
        restart_interval=ri)


def _plain(x):
    """A binding's result as comparable plain data."""
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if dataclasses.is_dataclass(x):
        return tuple((f.name, _plain(getattr(x, f.name)))
                     for f in dataclasses.fields(x))
    if hasattr(x, "name") and hasattr(x, "value"):  # an enum member
        return (x.name, int(x.value))
    if isinstance(x, (bytes, bytearray)):
        return bytes(x)
    return x


def _call(error, fn, *args):
    try:
        return ("ok", _plain(fn(*args)))
    except error as exc:
        return ("error", exc.status.name, int(exc.status))


def _pack(nat, scan: bytes):
    """seg_lens, then pack_dense of every segment found."""
    lens, found = nat.seg_lens(scan, MAX_SEGS)
    nseg = max(1, min(found, MAX_SEGS))
    words = (lens.astype(np.int64) + 3) // 4
    word_off = np.concatenate([[0], np.cumsum(words)[:-1]]).astype(np.int32)
    dense = np.zeros(int(words.sum()) + 8, np.uint32)
    written = nat.pack_dense(scan, dense, word_off[:nseg] if lens.size
                             else np.zeros(1, np.int32), nseg)
    return lens, found, written, dense


def roundtrip(nat, error, data: bytes, params=None):
    """Every binding on one blob, as in ``test_native_fuzz.py``'s
    ``_native_roundtrip``: the outcome of each call, stopping after a parse
    refusal. ``params`` replaces the parse (hostile tables)."""
    if params is None:
        parsed = _call(error, nat.parse_header, data)
        if parsed[0] == "error":
            return [parsed]
        params = nat.parse_header(data)
        out = [parsed]
    else:
        out = []
    out.append(_call(error, nat.decode_scan, params))
    out.append(_call(error, _pack, nat, params.slice_data))
    out.append(_call(error, nat.index_scan, params, INDEX_SYMBOLS))
    return out


def _jax():
    from rocjpeg_tpu.runtime import native as jnative
    return jnative


def assert_same(data: bytes):
    """The port's bindings and the JAX package's agree on ``data``; returns
    the port's outcomes."""
    mine = roundtrip(native, RocJpegError, data)
    assert mine == roundtrip(_jax(), JaxRocJpegError, data)
    return mine


@pytest.mark.parametrize("base", list(BASES))
def test_truncation_sweep(base):
    blob = base_blob(BASES[base])
    n = len(blob)
    outcomes = [assert_same(blob[:cut]) for cut in
                list(range(0, 64)) + list(range(64, n, max(1, n // 96)))]
    assert sum(o[0][0] == "ok" for o in outcomes) > 10


@pytest.mark.parametrize("base", list(BASES))
def test_bitflip_sweep(base):
    rng = np.random.default_rng(5)
    raw = np.frombuffer(base_blob(BASES[base]), np.uint8).copy()
    refused = 0
    for _ in range(128):
        mut = raw.copy()
        mut[int(rng.integers(0, raw.size))] ^= 1 << int(rng.integers(0, 8))
        outcome = assert_same(mut.tobytes())
        refused += any(o[0] == "error" for o in outcome[1:])
    assert refused > 0


def test_garbage_headers():
    rng = np.random.default_rng(11)
    blobs = [b"", b"\xff", b"\xff\xd8", b"\xff\xd8\xff",
             b"\xff\xd8" + b"\xff" * 500,
             bytes(rng.integers(0, 256, 1024, np.uint8)),
             b"\xff\xd8" + bytes(rng.integers(0, 256, 2048, np.uint8))]
    for blob in blobs:
        assert assert_same(blob)[0][0] == "error"


@pytest.mark.parametrize("base", list(BASES))
def test_hostile_huffman_tables(base):
    """One AC value byte of a parsed table replaced, the same in both
    packages' parameters: the scan decode and the index walk fail cleanly
    or decode, alike."""
    blob = base_blob(BASES[base])
    rng = np.random.default_rng(13)
    for _ in range(16):
        tid = int(rng.integers(0, 2))
        params = [native.parse_header(blob), _jax().parse_header(blob)]
        assert isinstance(params[1], JaxParams)
        arr = np.asarray(params[0].huffman_tables[tid].ac_values,
                         np.uint8).copy()
        arr[rng.integers(0, arr.size)] = rng.integers(0, 256)
        for p in params:
            p.huffman_tables[tid].ac_values = arr.copy()
        assert (roundtrip(native, RocJpegError, blob, params[0])
                == roundtrip(_jax(), JaxRocJpegError, blob, params[1]))
