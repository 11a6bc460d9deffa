"""Chunks within K1's addressing, for frames of tens of megapixels.

K1 forms a coefficient's index in 32 bits. ``api.chunk_group`` therefore
splits a same-shape group by the spec's lane count and by
``kernels.wave.MAX_COEFFS`` coefficients, where the JAX package chunks by
count alone; the K1 wrapper refuses a larger group with a typed error on
both routes. Large frames are built by ``testing.corpus.strip_frame`` (one
encoded strip of 16 rows, its restart segments repeated), so their headers
parse at full size without encoding the frame. Where the split is held
against the JAX package, ``MAX_COEFFS`` is lowered to a few small images'
worth and the JAX decoder is given the same chunk width as its lane count.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rocjpeg_tpu import api as japi
from rocjpeg_tpu import types as jtypes
from rocjpeg_tpu_torch import api as tapi
from rocjpeg_tpu_torch import pipeline
from rocjpeg_tpu_torch import types as ttypes
from rocjpeg_tpu_torch.core import golden
from rocjpeg_tpu_torch.dist import mesh, sharding
from rocjpeg_tpu_torch.kernels import wave
from rocjpeg_tpu_torch.status import RocJpegError, Status
from rocjpeg_tpu_torch.testing import corpus, encoder
from rocjpeg_tpu_torch.types import OutputFormat
from test_torch_jaxlib import jax_native  # noqa: F401  (autouse)

F = OutputFormat
H100_LANES = dict(ttypes._GPU_LANES)["NVIDIA H100"]


@pytest.mark.parametrize("w, h, ri, widths", [
    (7680, 4320, 4, [32]),        # 8K UHD: 1,592,524,800 coefficients
    (9504, 6336, 3, [23, 9]),     # 61 Mpix: 32 would be 2,890,432,512
])
def test_chunk_group_at_the_cards_width(w, h, ri, widths):
    """32 frames at the H100's chunk width of 32 lanes: 8K stays one chunk,
    61-Mpix frames split 23 + 9, and no chunk passes K1's addressing."""
    assert H100_LANES == 32
    frame, _ = corpus.strip_frame(w, h, ri)
    p = tapi.JpegStream(frame).params
    assert (p.picture_width, p.picture_height) == (w, h)
    per_image = tapi.coefficients_per_image(p)
    assert per_image == w * h * 3 // 2  # 4:2:0: Y and two quarter planes
    chunks = tapi.chunk_group(list(range(32)), H100_LANES, per_image)
    assert [len(c) for c in chunks] == widths
    assert sum(chunks, []) == list(range(32))
    assert all(len(c) * per_image <= wave.MAX_COEFFS == 2 ** 31 - 1
               for c in chunks)


@pytest.mark.parametrize("lanes, per_image, width", [
    (32, 2 ** 31 - 1, 1),             # one image fills the addressing
    (32, 2 ** 30, 1),                 # two would pass it by one
    (32, 2 ** 30 - 64, 2),
    (32, 16384 * 16384 * 3, 2),       # the spec's largest frame, 4:4:4
    (8, 64, 8),                       # small frames: the lane count rules
    (0, 64, 1),                       # a spec of no lanes still decodes
])
def test_chunk_group_width(lanes, per_image, width):
    chunks = tapi.chunk_group(list(range(20)), lanes, per_image)
    assert {len(c) for c in chunks[:-1]} <= {width}
    assert 0 < len(chunks[-1]) <= width
    assert sum(chunks, []) == list(range(20))


def _small_group():
    p = tapi.JpegStream(encoder.encode_planes(
        encoder.random_planes("420", 32, 16, seed=1), "420",
        restart_interval=1)).params
    return pipeline.pack_group([p], "cpu")


def _wave_args(g, geom, device="cpu"):
    dp = g.packed
    tensors = [t.to(device) if t is not None else None for t in (
        dp.dense, dp.word_off, dp.img_base, dp.mcu_start, dp.mcu_count,
        dp.lane_bank, g.lentab, g.values)]
    return (*tensors, geom, dp.n_words, g.max_steps)


@pytest.mark.parametrize("route", ["wave_decode", "wave_decode_reference",
                                   "wave_decode on a device tensor"])
def test_k1_refuses_past_its_addressing(route):
    """A group of 2^31 coefficients raises a typed error before anything is
    allocated or launched, on the plain route, the plain version itself and
    the device route (meta tensors stand in for the card's: the refusal
    comes before the route is chosen)."""
    g = _small_group()
    per_image = g.geom.total_blocks * 64
    geom = dataclasses.replace(g.geom, batch=-(-2 ** 31 // per_image))
    fn = (wave.wave_decode_reference if route == "wave_decode_reference"
          else wave.wave_decode)
    device = "meta" if route.endswith("device tensor") else "cpu"
    before = wave.launches
    with pytest.raises(RocJpegError, match="32-bit addressing") as exc:
        fn(*_wave_args(g, geom, device))
    assert exc.value.status == Status.INVALID_PARAMETER
    assert wave.launches == before


def test_k1_addressing_boundary():
    """The last size K1 addresses passes the guard, the next one does not."""
    g = _small_group()
    geom = dataclasses.replace(g.geom, batch=1, total_blocks=2 ** 25 - 1)
    assert wave._out_size(geom) == 2 ** 31 - 64 <= wave.MAX_COEFFS
    with pytest.raises(RocJpegError, match="32-bit addressing"):
        wave._out_size(dataclasses.replace(geom, total_blocks=2 ** 25))


SMALL = (64, 64)  # 4:2:0: 64 + 32 blocks, 6,144 coefficients a frame


def _blobs(ri, n=5):
    return [encoder.encode_planes(encoder.photo_planes("420", *SMALL, seed=s),
                                  "420", restart_interval=ri)
            for s in range(n)]


@pytest.fixture
def three_a_chunk(monkeypatch):
    """K1's addressing lowered to three small frames' worth (and a bit)."""
    monkeypatch.setattr(wave, "MAX_COEFFS", 3 * 6144 + 100)
    return 3


def _jax_decode(blobs, fmt, entropy, width):
    jdec = japi.Decoder(spec=jtypes.TpuDecodeSpec(name="t",
                                                  num_decode_lanes=width),
                        device_entropy=entropy)
    imgs = jdec.decode_batched([japi.JpegStream(b) for b in blobs],
                               jtypes.DecodeParams(jtypes.OutputFormat(
                                   int(fmt))))
    return imgs, [(p, list(i)) for p, i in jdec.last_paths]


def _assert_same(jimgs, timgs):
    for a, b in zip(jimgs, timgs, strict=True):
        assert a.pitch == b.pitch
        for ca, cb in zip(a.channel, b.channel):
            assert (ca is None) == (cb is None)
            if ca is not None:
                np.testing.assert_array_equal(np.asarray(ca), cb.numpy())


@pytest.mark.parametrize("entropy, ri, path", [
    ("on", 1, "wave"), ("on", 0, "wave-virtual"), ("off", 2, "host")])
def test_decode_batched_splits_by_addressing(three_a_chunk, entropy, ri,
                                             path):
    """Eight lanes and a limit of three frames: every path chunks 3 + 2, as
    the JAX package does with three lanes, bytes equal."""
    blobs = _blobs(ri)
    tdec = tapi.Decoder(device="cpu", device_entropy=entropy)
    assert tdec.spec.num_decode_lanes == 8
    got = tdec.decode_batched([tapi.JpegStream(b) for b in blobs],
                              ttypes.DecodeParams(F.RGB))
    want, jpaths = _jax_decode(blobs, F.RGB, entropy, three_a_chunk)
    assert ([(p, list(i)) for p, i in tdec.last_paths] == jpaths
            == [(path, [0, 1, 2]), (path, [3, 4])])
    _assert_same(want, got)


def test_decode_into_splits_by_addressing(three_a_chunk):
    """decode_into into tensors: each chunk within the limit, every image in
    its own destination, equal to the numpy decode."""
    blobs = _blobs(1)
    w, h = SMALL
    dests = []
    for _ in blobs:
        d = ttypes.DecodedImage.empty()
        d.channel[0] = torch.zeros(h * 3 * w + 7, dtype=torch.uint8)
        d.pitch[0] = 3 * w
        dests.append(d)
    tdec = tapi.Decoder(device="cpu", device_entropy="on")
    tdec.decode_into([tapi.JpegStream(b) for b in blobs], dests,
                     ttypes.DecodeParams(F.RGB))
    assert [list(i) for _, i in tdec.last_paths] == [[0, 1, 2], [3, 4]]
    for blob, d in zip(blobs, dests):
        (ref, pitch), = golden.decode(blob, F.RGB)
        np.testing.assert_array_equal(
            d.channel[0][:h * pitch].reshape(h, pitch).numpy(), ref)
        assert not d.channel[0][h * pitch:].any()


def test_mesh_decoder_rows_split_by_addressing(three_a_chunk):
    """A mesh row is a Decoder: its shard of 5 splits 3 + 2 as well."""
    blobs = _blobs(1, n=10)
    md = sharding.MeshDecoder(mesh.make_mesh(devices=["cpu", "cpu"]),
                              device_entropy="on")
    got = md.decode_batched([tapi.JpegStream(b) for b in blobs],
                            ttypes.DecodeParams(F.NATIVE))
    paths = [[list(i) for _, i in dec.last_paths] for dec in md._decoders]
    md.close()
    assert all(len(c) <= 3 for row in paths for c in row)
    want, _ = _jax_decode(blobs, F.NATIVE, "on", 3)
    _assert_same(want, got)


def test_count_only_chunks_meet_the_guard(three_a_chunk, monkeypatch):
    """Without the split, a chunk past the limit reaches K1's wrapper,
    which refuses it with a typed error instead of dropping blocks."""
    monkeypatch.setattr(tapi, "chunk_group",
                        lambda idxs, lanes, per_image: [idxs])
    tdec = tapi.Decoder(device="cpu", device_entropy="on")
    with pytest.raises(RocJpegError, match="32-bit addressing") as exc:
        tdec.decode_batched([tapi.JpegStream(b) for b in _blobs(1)])
    assert exc.value.status == Status.INVALID_PARAMETER


def test_strip_frame_bands_decode_to_the_strip():
    """A frame stacked from a strip decodes, band by band, to the strip, in
    both packages' numpy decodes."""
    frame, strip = corpus.strip_frame(128, 80, 2, seed=4)
    from rocjpeg_tpu.core import golden as jgolden
    for fmt in (F.NATIVE, F.RGB):
        ref = golden.decode(strip, fmt)
        got = golden.decode(frame, fmt)
        assert [p for _, p in got] == [p for _, p in ref]
        for (band, _), (full, _) in zip(ref, got):
            rows = band.shape[0]
            assert full.shape[0] == 5 * rows
            for k in range(5):
                np.testing.assert_array_equal(full[k * rows:(k + 1) * rows],
                                              band)
        for (a, _), (b, _) in zip(got, jgolden.decode(
                frame, jtypes.OutputFormat(int(fmt)))):
            np.testing.assert_array_equal(a, np.asarray(b))
