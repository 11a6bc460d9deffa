"""Synthesized photo-like 4:2:0 corpora for the smoke run and the tests.

``build_corpus`` gives the same bytes, for the same arguments, as the JAX
package's benchmark corpus builder, and keeps its cache-key format, so a
corpus either of them cached is found by the other.
"""

from __future__ import annotations

import os

import numpy as np

from . import encoder

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE = os.path.join(_REPO, "build", "rjt_bench_corpus")


def _smooth_plane(rng, h, w, detail=8):
    """Photo-like content: low-frequency base + mild noise (keeps the
    entropy-coded symbol rate realistic, unlike white noise)."""
    base = rng.integers(0, 256, (h // detail + 1, w // detail + 1)).astype(
        np.float32)
    up = np.kron(base, np.ones((detail, detail), np.float32))[:h, :w]
    noise = rng.normal(0, 6, (h, w)).astype(np.float32)
    return np.clip(up + noise, 0, 255).astype(np.uint8)


def build_corpus(n_images, w, h, seed=0, ri_mcus=None, mixed_tables=False):
    """Synthesize (or load from the disk cache) ``n_images`` 4:2:0 JPEGs of
    ``w`` x ``h``. ``ri_mcus`` is the restart interval in MCUs (None: one
    MCU row; 0: no restart markers); ``mixed_tables`` alternates two Huffman
    table variants.

    A corpus is a pure function of the arguments, so it is cached as one
    ``.npz`` keyed by all of them, under ``BENCH_CORPUS_CACHE`` or, by
    default, ``build/rjt_bench_corpus`` of the checkout (encoding a 4K
    frame takes seconds, reading it back milliseconds)."""
    if ri_mcus is None:
        ri_mcus = (w + 15) // 16  # one MCU row per restart segment
    cache_dir = os.environ.get("BENCH_CORPUS_CACHE", DEFAULT_CACHE)
    key = f"v1_n{n_images}_w{w}_h{h}_s{seed}_ri{ri_mcus}_mt{int(mixed_tables)}"
    path = os.path.join(cache_dir, key + ".npz")
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                return [z[f"d{i}"].tobytes() for i in range(n_images)]
        except (OSError, ValueError, KeyError):
            pass  # corrupt or partial cache entry: rebuild below

    rng = np.random.default_rng(seed)
    datas = []
    for i in range(n_images):
        planes = [_smooth_plane(rng, h, w),
                  _smooth_plane(rng, h // 2, w // 2),
                  _smooth_plane(rng, h // 2, w // 2)]
        datas.append(encoder.encode_planes(
            planes, "420", restart_interval=ri_mcus,
            table_variant=(i % 2) if mixed_tables else 0))

    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + f".tmp{os.getpid()}.npz"  # .npz suffix: savez appends it
    np.savez(tmp, **{f"d{i}": np.frombuffer(d, np.uint8)
                     for i, d in enumerate(datas)})
    os.replace(tmp, path)
    return datas
