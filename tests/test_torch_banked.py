"""Per-image Huffman tables on the wave (table banks): the port against the
JAX package, over the matrix of ``tests/test_banked_tables.py``.

A decode group keys on shape alone; each distinct Huffman table set of the
group becomes a bank of K1's code tables and every lane carries its image's
bank index. Equal sets share a bank, 1 to 4 banks go through the wave on
real restart lanes and on virtual ones, past 4 the packer refuses and the
session API takes the host path. Everything is held byte-equal (tolerance
0) to ``rocjpeg_tpu``: the banked tables, the wave's coefficients (the
port's plain PyTorch wave on the port's own pack against the JAX wave on
the JAX pack, and the Pallas kernel under its interpreter), and the images
out of ``Decoder.decode_batched``. Inputs come from the port's
``testing/encoder.py``: two fixed table variants, and per-image optimized
tables for a third, fourth and fifth set.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rocjpeg_tpu import api as japi
from rocjpeg_tpu import types as jtypes
from rocjpeg_tpu.core.bitstream import JpegStreamParser as JaxParser
from rocjpeg_tpu.ops import device_entropy as de
from rocjpeg_tpu.status import RocJpegError as JaxRocJpegError
from rocjpeg_tpu_torch import api as tapi
from rocjpeg_tpu_torch import pipeline
from rocjpeg_tpu_torch import types as ttypes
from rocjpeg_tpu_torch.core import entropy
from rocjpeg_tpu_torch.core.bitstream import JpegStreamParser
from rocjpeg_tpu_torch.kernels import wave
from rocjpeg_tpu_torch.ops import tables
from rocjpeg_tpu_torch.status import RocJpegError
from rocjpeg_tpu_torch.core import golden
from rocjpeg_tpu_torch.testing import encoder
from rocjpeg_tpu_torch.types import OutputFormat
from test_torch_jaxlib import jax_native  # noqa: F401  (autouse)

F = OutputFormat
VIRTUAL_K = 60  # symbols per virtual lane at the wave level


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain wave steps over small tensors: torch's intra-op pool only
    spins there, against the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planes(css, w, h, seed, smooth=False):
    """Photo-like planes (a blocky base plus mild noise): far fewer symbols
    than uniform noise, and different statistics per seed, so optimized
    tables differ from image to image. ``smooth``: a ramp with a handful of
    AC coefficients per block, which keeps the Pallas interpreter's
    per-step Python loop short."""
    rng = np.random.default_rng(seed)
    hf, vf = {"420": (2, 2), "444": (1, 1), "400": (1, 1)}[css]

    def plane(ph, pw):
        if smooth:
            y = np.linspace(0, 120, ph, dtype=np.float32)[:, None]
            x = np.linspace(0, 90, pw, dtype=np.float32)[None, :]
            return np.clip(60 + y + x + rng.integers(0, 6, (ph, pw)), 0,
                           255).astype(np.uint8)
        base = rng.integers(0, 256, (ph // 8 + 1, pw // 8 + 1))
        up = np.kron(base, np.ones((8, 8)))[:ph, :pw]
        return np.clip(up + rng.normal(0, 4 + 3 * seed, (ph, pw)), 0,
                       255).astype(np.uint8)

    planes = [plane(h, w)]
    if css != "400":
        planes += [plane(h // vf, w // hf), plane(h // vf, w // hf)]
    return planes


def _blobs(n_sets, ri, css="420", w=64, h=64, repeat=1, smooth=False):
    """``repeat`` images for each of ``n_sets`` distinct Huffman table sets,
    interleaved: the encoder's two fixed variants first, then per-image
    optimized tables."""
    blobs = []
    for s in range(n_sets * repeat):
        k = s % n_sets
        planes = _planes(css, w, h, k if k >= 2 else s, smooth)
        blobs.append(encoder.encode_planes(
            planes, css, restart_interval=ri,
            **({"table_variant": k} if k < 2 else {"optimize": True})))
    return blobs


def _parsed(blobs):
    return ([JpegStreamParser().parse(b) for b in blobs],
            [JaxParser().parse(b) for b in blobs])


def test_banked_tables_dedup():
    """Equal table sets share a bank; a uniform group is the 1-bank layout
    of ``from_params``."""
    mine, ref = _parsed(_blobs(2, 4, w=136, h=104, repeat=2))
    tabs, bank_of = tables.DeviceScanTables.from_params_banked(mine)
    jtabs, jbank_of = de.DeviceScanTables.from_params_banked(ref)
    assert tabs.n_banks == jtabs.n_banks == 2
    np.testing.assert_array_equal(bank_of, [0, 1, 0, 1])
    np.testing.assert_array_equal(bank_of, jbank_of)
    assert tabs.lentab.shape == (8, 16)
    np.testing.assert_array_equal(tabs.lentab, jtabs.lentab)
    np.testing.assert_array_equal(tabs.values, jtabs.values)
    t1, b1 = tables.DeviceScanTables.from_params_banked(mine[:1])
    assert t1.n_banks == 1 and tuple(b1) == (0,)
    np.testing.assert_array_equal(
        t1.lentab, tables.DeviceScanTables.from_params(mine[0]).lentab)
    np.testing.assert_array_equal(
        t1.lentab, de.DeviceScanTables.from_params(ref[0]).lentab)


@pytest.mark.parametrize("n_sets", [3, 4])
def test_banked_tables_optimized_sets_match_jax(n_sets):
    mine, ref = _parsed(_blobs(n_sets, 2, repeat=2))
    tabs, bank_of = tables.DeviceScanTables.from_params_banked(mine)
    jtabs, jbank_of = de.DeviceScanTables.from_params_banked(ref)
    assert tabs.n_banks == jtabs.n_banks == n_sets
    np.testing.assert_array_equal(bank_of, list(range(n_sets)) * 2)
    np.testing.assert_array_equal(bank_of, jbank_of)
    np.testing.assert_array_equal(tabs.lentab, jtabs.lentab)
    np.testing.assert_array_equal(tabs.values, jtabs.values)


@pytest.mark.parametrize("max_banks", [1, 2])
def test_banked_overflow_raises(max_banks):
    mine, ref = _parsed(_blobs(3, 4))
    for mod, error, plist in ((tables, RocJpegError, mine),
                              (de, JaxRocJpegError, ref)):
        with pytest.raises(error) as ei:
            mod.DeviceScanTables.from_params_banked(plist,
                                                    max_banks=max_banks)
        assert (ei.value.status.name, int(ei.value.status)) == (
            "JPEG_NOT_SUPPORTED", -4)


def _jax_wave(ref, virtual):
    jtabs, bank_of = de.DeviceScanTables.from_params_banked(ref)
    total = de.GroupGeometry.from_params(ref[0], len(ref)).total_blocks
    if virtual:
        packed, _dc, _lom = de.pack_virtual_segments(ref, total, VIRTUAL_K,
                                                     bank_of=bank_of)
    else:
        packed = de.pack_segments(ref, total, dense=True, bank_of=bank_of)
    out, err, geom = de.decode_coefficients_on_device(ref, jtabs, packed)
    return np.asarray(out), np.asarray(err).reshape(-1), geom


def _check_wave_banked(blobs, n_banks, virtual=False):
    """The port's wave on the port's pack: equal to the JAX wave on the JAX
    pack, and (DC fixup applied for virtual lanes) to the port's own
    sequential entropy decode of every image."""
    mine, ref = _parsed(blobs)
    g = pipeline.pack_group(mine, "cpu",
                            virtual_k=VIRTUAL_K if virtual else None)
    assert g.lentab.shape[0] == 4 * n_banks
    dp = g.packed
    assert set(dp.lane_bank.numpy().tolist()) >= set(range(n_banks))
    out, err = wave.wave_decode(
        dp.dense, dp.word_off, dp.img_base, dp.mcu_start, dp.mcu_count,
        dp.lane_bank, g.lentab, g.values, g.geom, dp.n_words, g.max_steps)
    assert not bool(err.any())
    out_j, err_j, geom_j = _jax_wave(ref, virtual)
    assert dataclasses.astuple(g.geom) == dataclasses.astuple(geom_j)
    # The two packers pad the lane arrays to different lengths.
    n = min(err.numel(), err_j.size)
    np.testing.assert_array_equal(err.numpy()[:n], err_j[:n])
    assert not err_j[n:].any()
    np.testing.assert_array_equal(out.numpy(), out_j)
    # Against the sequential decode: component ci's blocks of image i.
    comps = de.unflatten_coefficients(out_j, geom_j, ref[0])
    if virtual:
        from rocjpeg_tpu.pipeline import _mcu_maps
        mcu_maps = _mcu_maps(geom_j)
        dc_flat, lom = dp.dc_flat.numpy(), dp.lane_of_mcu.numpy()
    for i, p in enumerate(mine):
        want = entropy.decode_scan(p)
        for ci, a in enumerate(want):
            b = np.asarray(comps[ci][i]).copy()
            if virtual:
                b[..., 0] += dc_flat[lom[i][mcu_maps[ci]], ci]
            np.testing.assert_array_equal(a, b[:a.shape[0], :a.shape[1]])


@pytest.mark.parametrize("n_banks", [2, 3, 4])
def test_banked_wave_real_restarts(n_banks):
    _check_wave_banked(_blobs(n_banks, 4), n_banks)


@pytest.mark.parametrize("n_banks", [2, 3, 4])
def test_banked_wave_virtual_restarts(n_banks):
    _check_wave_banked(_blobs(n_banks, 0), n_banks, virtual=True)


def test_banked_wave_pallas_interpret(monkeypatch):
    """The JAX package's Pallas kernel's banked select, under its
    interpreter, against the port's wave."""
    monkeypatch.setenv("ROCJPEG_TPU_WAVE", "pallas-interpret")
    _check_wave_banked(_blobs(2, 1, w=48, h=32, smooth=True), 2)


@pytest.fixture(scope="module")
def decoders():
    return {mode: (japi.Decoder(device_entropy=mode),
                   tapi.Decoder(device="cpu", device_entropy=mode))
            for mode in ("on", "off")}


def _decode_both(decoders, blobs, fmt, mode="on"):
    jdec, tdec = decoders[mode]
    a = jdec.decode_batched([japi.JpegStream(b) for b in blobs],
                            jtypes.DecodeParams(jtypes.OutputFormat(int(fmt))))
    b = tdec.decode_batched([tapi.JpegStream(b) for b in blobs],
                            ttypes.DecodeParams(fmt))
    assert ([p for p, _ in jdec.last_paths]
            == [p for p, _ in tdec.last_paths])
    assert len(jdec.last_error_flags) == len(tdec.last_error_flags)
    assert len(a) == len(b) == len(blobs)
    for x, y in zip(a, b):
        assert x.pitch == y.pitch
        for cx, cy in zip(x.channel, y.channel):
            assert (cx is None) == (cy is None)
            if cx is not None:
                np.testing.assert_array_equal(np.asarray(cx), cy.numpy())
    return b, tdec


API_CASES = [(n, ri, fmt) for n in (2, 3, 4) for ri in (4, 0)
             for fmt in (F.RGB, F.NATIVE)]


@pytest.mark.parametrize(
    "n_banks,ri,fmt", API_CASES,
    ids=[f"{n}banks-ri{ri}-{f.name}" for n, ri, f in API_CASES])
def test_api_mixed_tables_one_wave_group(decoders, n_banks, ri, fmt):
    """Mixed Huffman tables stay in ONE wave group (shape-only keying), on
    real and on virtual restart lanes, and decode byte-equal to the JAX
    package and to the independent numpy decode."""
    blobs = _blobs(n_banks, ri, repeat=2 if n_banks == 2 else 1)
    imgs, tdec = _decode_both(decoders, blobs, fmt)
    # One group: one path entry and one device error-flag array.
    assert [p for p, _ in tdec.last_paths] == ["wave" if ri
                                               else "wave-virtual"]
    assert len(tdec.last_error_flags) == 1, "mixed tables split the group"
    for blob, img in zip(blobs, imgs):
        for ci, (ref, pitch) in enumerate(golden.decode(blob, fmt)):
            assert img.pitch[ci] == pitch
            np.testing.assert_array_equal(img.channel[ci].numpy(), ref)


@pytest.mark.parametrize("ri", [4, 0])
def test_api_too_many_banks_falls_back_to_host(decoders, ri):
    """Five distinct table sets in one shape group: the packer refuses and
    both decoders take the host path, still exact."""
    blobs = _blobs(5, ri)
    imgs, tdec = _decode_both(decoders, blobs, F.Y)
    assert [p for p, _ in tdec.last_paths] == ["host"]
    for blob, img in zip(blobs, imgs):
        (ref, _), = golden.decode(blob, F.Y)
        np.testing.assert_array_equal(img.channel[0].numpy(), ref)


def test_api_mixed_tables_host_path(decoders):
    """The same mixed group with the device path forced off."""
    _imgs, tdec = _decode_both(decoders, _blobs(2, 4), F.Y, mode="off")
    assert [p for p, _ in tdec.last_paths] == ["host"]
