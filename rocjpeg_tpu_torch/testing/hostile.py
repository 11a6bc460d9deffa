"""Hostile inputs for the port's robustness checks, and the comparisons they
go through.

The blobs are those of the JAX package's ``tests/test_fuzz.py`` (truncation
sweep, seeded bit flips, garbage) and the batches those of its
``tests/test_soak.py`` (its shape matrix, restart intervals with DRI=0,
table variants, optimized tables and mutations), made by the port's encoder,
which is held byte-equal to the JAX one. Each comparison takes a *subject*
and a *reference*, each a (session module, error class, decoder) triple, so
that the same code holds the port on the CPU against the JAX package
(``tests/test_torch_fuzz.py``, ``tests/test_torch_soak.py``) and the port on
a card against the port on the CPU (``chip_smoke.py``). Only typed errors
are caught: anything else propagates.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..types import OutputFormat
from . import encoder

# tests/test_fuzz.py's base image and sweeps.
N_CUTS, N_FLIPS, N_GARBAGE = 16, 24, 6

# tests/test_soak.py's matrix: every subsampling but 4:1:1, odd and even
# sizes, all at least the 64x64 minimum; its five output formats by value.
SOAK_SHAPES = [("444", 64, 64), ("440", 80, 68), ("422", 90, 70),
               ("420", 88, 72), ("420", 97, 65), ("420", 96, 64),
               ("400", 73, 81), ("422", 64, 96)]
SOAK_FORMATS = (OutputFormat.NATIVE, OutputFormat.RGB, OutputFormat.Y,
                OutputFormat.YUV_PLANAR, OutputFormat.RGB_PLANAR)
SOAK_ENTROPY = ("auto", "on")
SOAK_SEED = 0


def fuzz_base() -> bytes:
    """The fuzz suite's base image: 96x64 4:2:0, restart interval 2."""
    return encoder.encode_planes(encoder.random_planes("420", 96, 64, seed=3),
                                 "420", restart_interval=2)


def fuzz_blobs() -> list:
    """(kind, bytes) of every hostile input of ``tests/test_fuzz.py``, in its
    order: 16 truncations, 24 bit flips (its seed), 6 garbage blobs (its
    seed)."""
    base = fuzz_base()
    n = len(base)
    cuts = sorted({2, 4, 8, 16, 21, 64, 100, 150, 200, n // 4, n // 3,
                   n // 2, 2 * n // 3, n - 40, n - 7, n - 1})
    out = [("trunc", base[:c]) for c in cuts]
    rng = np.random.default_rng(0)
    for _ in range(N_FLIPS):
        mutated = bytearray(base)
        for _ in range(rng.integers(1, 4)):
            i = int(rng.integers(2, len(mutated)))
            mutated[i] ^= int(rng.integers(1, 256))
        out.append(("bitflip", bytes(mutated)))
    rng = np.random.default_rng(1)
    for blob in (b"", b"\x00", b"\xff\xd8", b"\xff" * 64,
                 rng.integers(0, 256, 512, dtype=np.uint8).tobytes(),
                 b"\xff\xd8\xff\xd9"):
        out.append(("garbage", blob))
    return out


def host_channels(img) -> list:
    """An image's channels as flat host arrays (None where absent), from
    torch tensors on any device or from arrays."""
    return [None if c is None else
            (c.cpu().numpy() if isinstance(c, torch.Tensor)
             else np.asarray(c)).reshape(-1)
            for c in img.channel]


def outcome(side, blob, fmt) -> tuple:
    """What one (module, error, decoder) side makes of one blob, decoded
    alone as ``fmt``: ("error", status name) for a typed refusal, else
    ("decoded", failed indices, channel bytes and pitches), without the
    channels when a lane was flagged (the packages write different garbage
    there)."""
    mod, error, dec = side
    try:
        img = dec.decode(mod.JpegStream(blob),
                         mod.DecodeParams(mod.OutputFormat(int(fmt))))
    except error as exc:
        return ("error", exc.status.name)
    failed = dec.last_failed_indices()
    if failed:
        return ("decoded", failed, None)
    return ("decoded", failed,
            [(None if c is None else c.tobytes(), p)
             for c, p in zip(host_channels(img), img.pitch)])


def soak_blob(rng):
    """One encoded image of a random configuration, and its label."""
    css, w, h = SOAK_SHAPES[int(rng.integers(len(SOAK_SHAPES)))]
    ri = int(rng.choice([0, 0, 1, 2, 5]))
    tv = int(rng.integers(0, 2))
    opt = bool(rng.integers(0, 2))
    planes = encoder.random_planes(css, w, h, seed=int(rng.integers(1 << 30)))
    return (encoder.encode_planes(planes, css, restart_interval=ri,
                                  table_variant=tv, optimize=opt),
            f"{css}_ri{ri}")


def soak_mutate(rng, blob):
    """Half the images clean; the rest truncated, bit-flipped or given an
    embedded marker."""
    kind = 0 if rng.random() < 0.5 else int(rng.integers(1, 4))
    b = bytearray(blob)
    if kind == 0:
        return blob, "clean"
    if kind == 1:
        cut = int(rng.integers(2, len(b)))
        return bytes(b[:cut]), "trunc"
    if kind == 2:
        for _ in range(int(rng.integers(1, 5))):
            i = int(rng.integers(2, len(b)))
            b[i] ^= int(rng.integers(1, 256))
        return bytes(b), "bitflip"
    i = int(rng.integers(2, len(b) - 2))
    b[i:i + 2] = bytes([0xFF, int(rng.choice([0xD0, 0xC2, 0x01, 0xD9]))])
    return bytes(b), "marker"


def soak_batch(i: int):
    """Iteration ``i`` of the soak: (output format, entropy mode,
    [(blob, kind, config label), ...]), a pure function of ``SOAK_SEED``
    and ``i``."""
    rng = np.random.default_rng((SOAK_SEED, i))
    batch = []
    for _ in range(int(rng.integers(2, 6))):
        blob, cfg = soak_blob(rng)
        mutated, kind = soak_mutate(rng, blob)
        batch.append((mutated, kind, cfg))
    return (SOAK_FORMATS[i % len(SOAK_FORMATS)],
            SOAK_ENTROPY[i % len(SOAK_ENTROPY)], batch)


def _check(ok: bool, *what) -> None:
    """An assertion that ``python -O`` keeps."""
    if not ok:
        raise AssertionError(" ".join(str(w) for w in what))


def new_stats() -> dict:
    return {"clean": 0, "clean_exact": 0, "mutated": 0,
            "mutated_typed_error": 0, "mutated_decoded": 0, "batches": 0,
            "mixed_batches": 0, "failed_images": 0, "configs": set()}


def _parse(side, blob):
    mod, error, _ = side
    try:
        return mod.JpegStream(blob), None
    except error as exc:
        return None, exc.status.name


def _decode(side, streams, fmt):
    mod, error, dec = side
    try:
        imgs = dec.decode_batched(
            streams, mod.DecodeParams(mod.OutputFormat(int(fmt))))
    except error as exc:
        return None, exc.status.name
    return imgs, dec.last_failed_indices()


def check_batch(batch, fmt, subject, reference, golden, stats) -> None:
    """One batch through both sides. Every stream parses in both or is
    refused by both with the same status name, and no clean stream is
    refused; the batch decodes in both or is refused by both alike, never
    when it is all clean; the failed indices are equal and hold no clean
    image; clean images are byte-equal to ``golden(blob, fmt)`` (a list of
    (array, pitch)) and every image no lane flagged to the reference's."""
    kept = []
    for blob, kind, cfg in batch:
        stats["configs"].add(cfg)
        mine, mine_err = _parse(subject, blob)
        theirs, their_err = _parse(reference, blob)
        _check(mine_err == their_err, kind, mine_err, their_err)
        if mine_err:
            _check(kind != "clean", mine_err)
            stats["mutated"] += 1
            stats["mutated_typed_error"] += 1
        else:
            kept.append((mine, theirs, blob, kind))
    if not kept:
        return
    imgs, failed = _decode(subject, [k[0] for k in kept], fmt)
    ref_imgs, ref_failed = _decode(reference, [k[1] for k in kept], fmt)
    _check(failed == ref_failed, failed, ref_failed)
    stats["batches"] += 1
    kinds = [k[3] for k in kept]
    if imgs is None:  # the whole batch refused, with one typed status
        _check(any(k != "clean" for k in kinds), failed)
        n_mut = sum(k != "clean" for k in kinds)
        stats["mutated"] += n_mut
        stats["mutated_typed_error"] += n_mut
        return
    stats["mixed_batches"] += len(set(k == "clean" for k in kinds)) > 1
    stats["failed_images"] += len(failed)
    for j, ((_, _, blob, kind), img, ref) in enumerate(
            zip(kept, imgs, ref_imgs)):
        got = host_channels(img)
        if kind == "clean":
            _check(j not in failed, j)
            stats["clean"] += 1
            for (want, _pitch), chan in zip(golden(blob, fmt), got):
                want = np.asarray(want).reshape(-1)
                _check(chan is not None and np.array_equal(
                    chan[:want.size], want), "clean image", j, fmt)
            stats["clean_exact"] += 1
        else:
            stats["mutated"] += 1
            stats["mutated_decoded"] += 1
        if j not in failed:
            _check(list(img.pitch) == list(ref.pitch), j)
            for a, b in zip(got, host_channels(ref)):
                _check((a is None) == (b is None)
                       and (a is None or np.array_equal(a, b)),
                       "image", j, "differs from the reference's")


def run_soak(budget_s: float, min_iterations: int, sides, golden) -> dict:
    """Soak iterations 0, 1, ... until ``min_iterations`` are done and
    ``budget_s`` is spent. ``sides`` maps each entropy mode to its
    (subject, reference) pair. Returns the counts."""
    stats = new_stats()
    t_end = time.monotonic() + budget_s
    it = 0
    while it < min_iterations or time.monotonic() < t_end:
        fmt, entropy, batch = soak_batch(it)
        check_batch(batch, fmt, *sides[entropy], golden, stats)
        it += 1
    stats["configs"] = sorted(stats["configs"])
    stats["iterations"] = it
    return stats
