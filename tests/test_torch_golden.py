"""The port's numpy oracle (``rocjpeg_tpu_torch.core.golden``) against the
JAX package's (``rocjpeg_tpu.core.golden``): the same seeded streams give
the same planes and the same channels, byte for byte, for every
subsampling and output format, with and without a valid crop."""

import functools

import numpy as np
import pytest

from rocjpeg_tpu.core import golden as jgolden
from rocjpeg_tpu.core.bitstream import JpegStreamParser as JParser
from rocjpeg_tpu.types import CropRectangle as JCrop
from rocjpeg_tpu.types import OutputFormat as JFormat
from rocjpeg_tpu_torch.core import golden
from rocjpeg_tpu_torch.core.bitstream import JpegStreamParser
from rocjpeg_tpu_torch.testing import encoder
from rocjpeg_tpu_torch.types import CropRectangle, OutputFormat
from test_torch_jaxlib import jax_native  # noqa: F401  (autouse)

CSS = ["444", "440", "422", "420", "400"]
CROP = (16, 8, 80, 72)


@functools.lru_cache(maxsize=None)
def _blob(css):
    return encoder.encode_planes(
        encoder.random_planes(css, 128, 96, seed=len(css) + CSS.index(css)),
        css, restart_interval=3)


@pytest.mark.parametrize("fmt", list(OutputFormat), ids=lambda f: f.name)
@pytest.mark.parametrize("css", CSS)
def test_golden_decode_matches_jax(css, fmt):
    for crop in (None, CROP):
        mine = golden.decode(_blob(css), fmt,
                             CropRectangle(*crop) if crop else None)
        theirs = jgolden.decode(_blob(css), JFormat(int(fmt)),
                                JCrop(*crop) if crop else None)
        assert [p for _, p in mine] == [p for _, p in theirs]
        for (a, _), (b, _) in zip(mine, theirs, strict=True):
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("css", CSS)
def test_golden_decode_planes_matches_jax(css):
    mine = golden.decode_planes(JpegStreamParser().parse(_blob(css)))
    theirs = jgolden.decode_planes(JParser().parse(_blob(css)))
    assert len(mine) == len(theirs) == 3
    for a, b in zip(mine, theirs):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b))
    assert (mine[1] is None) == (css == "400")

