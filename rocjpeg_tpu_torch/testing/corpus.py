"""Synthesized photo-like 4:2:0 corpora for the smoke run and the tests.

``build_corpus`` gives the same bytes, for the same arguments, as the JAX
package's benchmark corpus builder, and keeps its cache-key format, so a
corpus either of them cached is found by the other.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.bitstream import JpegStreamParser
from ..kernels.build import build_dir
from . import encoder

DEFAULT_CACHE = build_dir("rjt_bench_corpus")


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
    default, ``build/rjt_bench_corpus`` of the checkout (of the user's
    cache for an installed package, ``kernels.build.build_dir``; encoding
    a 4K frame takes seconds, reading it back milliseconds)."""
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


def _marker_at(data: bytes, code: int) -> int:
    """Offset of the first ``FF code`` marker of a JPEG's header."""
    i = 2
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            raise ValueError(f"no marker at offset {i}")
        if data[i + 1] == code:
            return i
        i += 2 + int.from_bytes(data[i + 2:i + 4], "big")
    raise ValueError(f"no FF{code:02X} marker")


def stack_strip(strip: bytes, copies: int) -> bytes:
    """A baseline JPEG of ``copies`` copies of ``strip`` stacked vertically,
    without encoding the frame: its scan is the strip's restart segments
    repeated, the RSTn markers renumbered in order. The strip must be whole
    MCU rows high and its restart interval must divide its MCU count, so
    that every segment starts at a copy's first MCU row or inside one; the
    frame's every band of the strip's height then decodes to the strip.
    Makes frames of tens of megapixels in a fraction of a second."""
    p = JpegStreamParser().parse(strip)
    mcu_h = 8 * max(c.v_sampling_factor for c in p.components)
    if (p.restart_interval == 0 or p.num_mcus % p.restart_interval
            or p.picture_height % mcu_h or strip[-2:] != b"\xff\xd9"):
        raise ValueError("the strip must be whole MCU rows of whole "
                         "restart segments, ending in EOI")
    sof = _marker_at(strip, 0xC0)
    sos = _marker_at(strip, 0xDA)
    scan0 = sos + 2 + int.from_bytes(strip[sos + 2:sos + 4], "big")
    segments, start, i = [], scan0, scan0
    end = len(strip) - 2
    while i < end - 1:
        if strip[i] == 0xFF and 0xD0 <= strip[i + 1] <= 0xD7:
            segments.append(strip[start:i])
            start = i = i + 2
        else:
            i += 1
    segments.append(strip[start:end])
    height = int.from_bytes(strip[sof + 5:sof + 7], "big") * copies
    if height > 0xFFFF:
        raise ValueError(f"a frame {height} rows high")
    out = bytearray(strip[:sof + 5] + height.to_bytes(2, "big")
                    + strip[sof + 7:scan0])
    n = copies * len(segments)
    for k in range(n):
        out += segments[k % len(segments)]
        if k + 1 < n:
            out += bytes((0xFF, 0xD0 + k % 8))
    return bytes(out + b"\xff\xd9")


def strip_frame(w: int, h: int, ri_mcus: int, seed: int = 0):
    """A ``w`` x ``h`` 4:2:0 frame of the benchmark corpus's content made
    by :func:`stack_strip` from one strip of 16 rows (one MCU row), whose
    restart interval ``ri_mcus`` must divide its ``w / 16`` MCUs. Returns
    (frame, strip)."""
    rng = np.random.default_rng(seed)
    planes = [_smooth_plane(rng, 16, w), _smooth_plane(rng, 8, w // 2),
              _smooth_plane(rng, 8, w // 2)]
    strip = encoder.encode_planes(planes, "420", restart_interval=ri_mcus)
    return stack_strip(strip, h // 16), strip
