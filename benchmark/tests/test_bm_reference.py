"""The plain reference against an independent decoder: libjpeg (through
PIL) decodes the benchmark's streams to the reference's luma exactly,
with and without restart markers."""

import io
import json
import os

import numpy as np
import pytest

from conftest import BENCH


def config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,w,h,restart", [
    ("imagenet", 500, 375, 0), ("imagenet", 333, 500, 0),
    ("imagenet", 500, 357, 4), ("uhd420", 1024, 576, 0),
    ("uhd420", 640, 368, 1)])
def test_libjpeg_decodes_the_reference_luma(name, w, h, restart):
    Image = pytest.importorskip("PIL.Image")
    from harness import content
    from references import jpeg_baseline as ref
    cfg = config(name)
    data = content.encode(cfg, 99, 1, [3], w, h, restart)[0]
    im = Image.open(io.BytesIO(data))
    im.draft("YCbCr", im.size)
    y = np.asarray(im)[..., 0]
    want = ref.decode(cfg, 99, 1, 3, w, h, "native")
    assert y.shape == want[0].shape
    assert np.array_equal(y, want[0])
    rgb = ref.decode(cfg, 99, 1, 3, w, h, "rgb")[0]
    assert rgb.shape == (h, 3 * w)


def test_the_control_idct_differs_by_rounding():
    """ifast differs from islow in some bytes, by little."""
    from references import jpeg_baseline as ref
    cfg = config("imagenet")
    a = ref.decode(cfg, 4, 0, 0, 500, 375, "rgb", "islow")[0]
    b = ref.decode(cfg, 4, 0, 0, 500, 375, "rgb", "ifast")[0]
    diff = np.abs(a.astype(int) - b)
    assert 0 < np.count_nonzero(diff) and diff.max() <= 8
