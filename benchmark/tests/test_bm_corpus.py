"""Each configuration's work is fixed by the configuration: every seed
gives the same shapes, images and pixels a call. The seed draws content
and order only."""

import collections
import json
import os

import pytest

from conftest import BENCH


def config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["uhd420", "imagenet"])
def test_same_work_for_every_seed(name):
    from harness import corpus
    cfg = config(name)
    first = None
    for seed in list(range(12)) + [2 ** 31 + 11, 2 ** 40 + 3]:
        batches = corpus.plan(cfg, seed)
        assert len(batches) == cfg["rotation"]
        work = [(len(b.images), b.pixels, sorted(collections.Counter(
            (im.width, im.height) for im in b.images).items()))
            for b in batches]
        assert len(set(map(repr, work))) == 1
        first = first or work[0]
        assert work[0] == first
    print(f"{name}: {first[0]} images, {first[1] / 1e6} Mpix a call")


@pytest.mark.parametrize("name,seeds", [("imagenet", range(12)),
                                        ("uhd420", range(2))])
def test_bits_per_pixel_close_across_seeds(name, seeds):
    """Content statistics are the configuration's: one image a seed (each
    of imagenet's shapes in turn) lands within 10% of the mean."""
    from harness import content
    cfg = config(name)
    bpp = []
    for seed in seeds:
        w, h, _ = cfg["shapes"][seed % len(cfg["shapes"])]
        data = content.encode(cfg, seed, 0, [0], w, h)[0]
        bpp.append(8 * len(data) / (w * h))
    mean = sum(bpp) / len(bpp)
    print(f"{name}: bits per pixel {[round(b, 4) for b in bpp]}")
    assert all(abs(b - mean) < 0.1 * mean for b in bpp)


def test_seed_changes_content_and_order():
    from harness import content, corpus
    cfg = config("imagenet")
    a, b = corpus.plan(cfg, 1), corpus.plan(cfg, 2)
    assert [im.slot for im in a[0].images] != [im.slot for im in b[0].images]
    assert content.encode(cfg, 1, 0, [0], 500, 375) != content.encode(
        cfg, 2, 0, [0], 500, 375)
    assert content.encode(cfg, 1, 0, [0], 500, 375) == content.encode(
        cfg, 1, 0, [0], 500, 375)
