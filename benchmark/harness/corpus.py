"""A cell's corpus: the rotation of batches its clients send.

The configuration fixes every batch's shapes and counts (``shapes``:
[width, height, images a batch]) and the number of distinct batches in
the rotation (``rotation``); the mix fixes the restart interval. The seed
draws each image's content and the order of the images within each
batch, nothing else, so every seed gives the same images, pixels and
chunks a call. Images are encoded on a pool of worker processes
(``harness.pool``) that import NumPy only.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import content


@dataclasses.dataclass
class Image:
    batch: int
    slot: int
    width: int
    height: int


@dataclasses.dataclass
class Batch:
    """One batch of the rotation: its images in the order sent, their
    streams, and the length of each stream's entropy-coded data."""
    index: int
    images: list
    datas: list = None
    scan_bytes: list = None

    @property
    def pixels(self) -> int:
        return sum(im.width * im.height for im in self.images)


def plan(config: dict, seed: int) -> list:
    """The rotation's batches, without streams: shapes from the
    configuration, the order of each batch's images from the seed."""
    shapes = [(int(w), int(h)) for w, h, n in config["shapes"]
              for _ in range(int(n))]
    order_rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed) & (2 ** 64 - 1), 1 << 20]))
    batches = []
    for b in range(int(config["rotation"])):
        perm = order_rng.permutation(len(shapes))
        batches.append(Batch(b, [Image(b, s, *shapes[s]) for s in perm]))
    return batches


# Pixels of one encoding job: small images are entropy-coded together.
JOB_PIXELS = 4_000_000


def encode_job(args) -> list:
    """Streams and scan lengths of same-shape images (runs in a
    worker)."""
    config, seed, batch, slots, width, height, restart = args
    return [(d, scan_length(d)) for d in content.encode(
        config, seed, batch, slots, width, height, restart)]


def scan_length(data: bytes) -> int:
    """Bytes of entropy-coded data: from the end of the SOS segment to the
    EOI marker, stuffing and restart markers included."""
    sos = data.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    return len(data) - 2 - start


def start(config: dict, mix: dict, seed: int, pool):
    """The rotation without its streams, and the pending result of their
    encoding on ``pool`` (a ``multiprocessing`` pool); :func:`finish`
    fills them in."""
    batches = plan(config, seed)
    restart = int(mix.get("restart_mcus", 0))
    jobs = []
    for b in batches:
        by_shape = {}
        for im in b.images:
            by_shape.setdefault((im.width, im.height), []).append(im.slot)
        for (w, h), slots in sorted(by_shape.items()):
            step = max(1, JOB_PIXELS // (w * h))
            for i in range(0, len(slots), step):
                jobs.append((config, seed, b.index, slots[i:i + step], w, h,
                             restart))
    # The largest jobs first, so the pool ends together.
    jobs.sort(key=lambda j: -len(j[3]) * j[4] * j[5])
    return batches, (jobs, pool.map_async(encode_job, jobs, chunksize=1))


def finish(batches: list, pending) -> list:
    jobs, result = pending
    got = {}
    for job, out in zip(jobs, result.get()):
        for slot, enc in zip(job[3], out):
            got[(job[2], slot)] = enc
    for b in batches:
        b.datas = [got[(b.index, im.slot)][0] for im in b.images]
        b.scan_bytes = [got[(b.index, im.slot)][1] for im in b.images]
    return batches


def bits_per_pixel(batches: list) -> float:
    return 8 * sum(sum(len(d) for d in b.datas) for b in batches) / sum(
        b.pixels for b in batches)
