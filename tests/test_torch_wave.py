"""K1 parity: the port's wave decode and packer against the JAX package.

The same packed group — from the JAX package's own packer — goes through
the JAX wave (``decode_coefficients_on_device``: the jnp wave on CPU, and
once the Pallas kernel under the Pallas interpreter) and through the
port's plain PyTorch version of K1 (``wave_decode`` on CPU tensors, via
``convert.py``). Coefficients and per-lane error flags must be equal: the
tolerance is zero. The port's own packer must equal the JAX packer on the
unpadded lane prefix. Streams come from the port's encoder and are parsed
once by the JAX parser; ``convert.params_from_jax`` carries them to the
port. The CUDA kernel itself is held against the plain version on the card
(``chip_smoke.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from rocjpeg_tpu.core.bitstream import JpegStreamParser
from rocjpeg_tpu.ops import device_entropy as de
from rocjpeg_tpu.status import RocJpegError as JaxRocJpegError
from rocjpeg_tpu_torch import convert
from rocjpeg_tpu_torch.kernels import wave
from rocjpeg_tpu_torch.ops import pack, tables
from rocjpeg_tpu_torch.status import RocJpegError
from rocjpeg_tpu_torch.testing import encoder
from test_torch_jaxlib import jax_native  # noqa: F401  (autouse)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain wave steps over small tensors: torch's intra-op pool only
    spins there, against the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _streams(css, ri, w=48, h=32, seeds=(0, 1), variants=None,
             content="photo"):
    out = []
    for i, s in enumerate(seeds):
        planes = (encoder.random_planes(css, w, h, seed=s)
                  if content == "random" else _planes(css, w, h, s, content))
        out.append(JpegStreamParser().parse(encoder.encode_planes(
            planes, css, restart_interval=ri,
            table_variant=variants[i] if variants else 0)))
    return out


def _planes(css, w, h, seed, content):
    """'photo': a blocky low-frequency base plus mild noise; 'gradient': a
    smooth ramp with a handful of AC coefficients per block (keeps the
    Pallas interpreter's per-step Python loop short). Both need far fewer
    wave steps than uniform noise ('random')."""
    rng = np.random.default_rng(seed)
    hf, vf = {"444": (1, 1), "440": (1, 2), "422": (2, 1), "420": (2, 2),
              "400": (1, 1)}[css]

    def plane(ph, pw):
        if content == "gradient":
            y = np.linspace(0, 120, ph, dtype=np.float32)[:, None]
            x = np.linspace(0, 90, pw, dtype=np.float32)[None, :]
            img = 60 + y + x + rng.integers(0, 6, (ph, pw))
        else:
            base = rng.integers(0, 256, (ph // 8 + 1, pw // 8 + 1))
            img = (np.kron(base, np.ones((8, 8)))[:ph, :pw]
                   + rng.normal(0, 6, (ph, pw)))
        return np.clip(img, 0, 255).astype(np.uint8)

    planes = [plane(h, w)]
    if css != "400":
        planes += [plane(h // vf, w // hf), plane(h // vf, w // hf)]
    return planes


def _jax_pack(plist, virtual_k=None, mcu_range=None):
    tabs, bank_of = de.DeviceScanTables.from_params_banked(plist)
    total_blocks = de.GroupGeometry.from_params(plist[0], len(plist)).total_blocks
    if virtual_k:
        packed, dc_flat, lom = de.pack_virtual_segments(
            plist, total_blocks, virtual_k, mcu_range=mcu_range,
            bank_of=bank_of)
    else:
        packed = de.pack_segments(plist, total_blocks, dense=True,
                                  mcu_range=mcu_range, bank_of=bank_of)
        dc_flat = lom = None
    return tabs, packed, dc_flat, lom


def _port(plist):
    """The JAX parser's params as the port's own."""
    return [convert.params_from_jax(p) for p in plist]


def _port_wave(plist, tabs, packed, dc_flat=None, lom=None, max_steps=None):
    geom = tables.GroupGeometry.from_params(_port(plist)[0], len(plist))
    dp = convert.packed_from_numpy(packed, dc_flat, lom, "cpu")
    lentab, values = convert.tables_from_numpy(tabs, "cpu")
    out, err = wave.wave_decode(
        dp.dense, dp.word_off, dp.img_base, dp.mcu_start, dp.mcu_count,
        dp.lane_bank, lentab, values, geom, dp.n_words,
        max_steps or tables.max_steps_bound(geom, packed))
    return geom, out.numpy(), err.numpy()


def _check(plist, virtual_k=None, flags_only=False, mcu_range=None,
           max_steps=None):
    """Both waves on one JAX pack; returns the port's (coefficients, error
    flags). ``max_steps`` is the symbol bound both sides run with instead
    of the packer's."""
    tabs, packed, dc_flat, lom = _jax_pack(plist, virtual_k, mcu_range)
    out_j, err_j, geom_j = de.decode_coefficients_on_device(plist, tabs,
                                                            packed)
    geom, out_t, err_t = _port_wave(plist, tabs, packed, dc_flat, lom,
                                    max_steps)
    assert dataclasses.astuple(geom) == dataclasses.astuple(geom_j)
    np.testing.assert_array_equal(np.asarray(err_j).reshape(-1), err_t)
    if not flags_only:
        np.testing.assert_array_equal(np.asarray(out_j), out_t)
    return out_t, err_t


def _errs(*args, **kwargs):
    return _check(*args, **kwargs)[1]


@pytest.mark.parametrize("css", ["444", "440", "422", "420", "400"])
def test_wave_restart_lanes_css(css):
    assert not _errs(_streams(css, 1)).any()


@pytest.mark.parametrize("ri", [0, 3])
def test_wave_restart_intervals(ri):
    # ri=0: one lane carries the whole image (the DRI=0 lane shape).
    assert not _errs(_streams("420", ri, content="random")).any()


@pytest.mark.parametrize("css", ["444", "440", "422", "420", "400"])
def test_wave_virtual_lanes_css(css):
    assert not _errs(_streams(css, 0, w=64, h=48), virtual_k=60).any()


def test_wave_long_codes():
    # Max-magnitude coefficients force 16-bit AC codes + 10-bit extends.
    rng = np.random.default_rng(6)
    coeffs = [rng.choice([-1023, 1023, -255, 255], (2, 8, 64)).astype(np.int32)]
    data = encoder.encode_coefficients(coeffs, encoder.SAMPLING["400"], 64,
                                       16, [encoder.QTABLE_LUMA], [0],
                                       restart_interval=1)
    assert not _errs([JpegStreamParser().parse(data)]).any()


def test_wave_two_banks():
    plist = _streams("420", 2, variants=(0, 1))
    tabs, _, _, _ = _jax_pack(plist)
    assert tabs.n_banks == 2
    assert not _errs(plist).any()


def test_wave_corrupt_scan_flags():
    # Colliding writes of a corrupt lane land in undefined order: compare
    # only the error flags.
    plist = _streams("420", 0, seeds=(1,))
    bad = bytearray(plist[0].slice_data)
    bad[16:64] = b"\xff\x00" * 24  # a run of one-bits no code has
    plist[0].slice_data = bytes(bad)
    assert _errs(plist, flags_only=True).any()


@pytest.mark.parametrize("ri,virtual_k", [(1, None), (2, None), (0, 40)])
def test_wave_roi_pack_leaves_skipped_bands_zero(ri, virtual_k):
    """A pack of the middle MCU rows only: the blocks of the rows above and
    below belong to no lane, and both waves leave them zero. The CUDA kernel
    allocates its output uninitialised and must give these same zeroes
    (held against this plain version on the card)."""
    plist = _streams("420", ri, w=64, h=64)  # 4 x 4 MCUs an image
    full, _ = _check(plist, virtual_k)
    out, err = _check(plist, virtual_k, mcu_range=(4, 12))
    assert not err.any()
    luma = out.reshape(2, -1)[:, :64 * 64].reshape(2, 8, 8, 64)  # block rows
    full_luma = full.reshape(2, -1)[:, :64 * 64].reshape(2, 8, 8, 64)
    assert not luma[:, 0].any() and not luma[:, 7].any()
    assert full_luma[:, 0].any() and full_luma[:, 7].any()
    np.testing.assert_array_equal(luma[:, 3:5], full_luma[:, 3:5])


@pytest.mark.parametrize("steps", [4, 20, 62])
def test_wave_lane_cut_by_max_steps(monkeypatch, steps):
    """A lane stopped by max_steps keeps what it decoded (a part of a block
    included), leaves the rest of its MCUs zero and raises its flag. Even
    bounds only: the JAX wave takes two steps a turn of its loop."""
    monkeypatch.setattr(de, "max_steps_bound", lambda geom, packed: steps)
    plist = _streams("420", 4, w=64, h=32)
    out, err = _check(plist, max_steps=steps)
    n = 2 * 2  # 8 MCUs an image, 4 a lane
    assert err[:n].all() and not err[n:].any()
    assert out.any()
    assert np.count_nonzero(out) <= n * steps


def test_wave_matches_pallas_interpret(monkeypatch):
    """The TPU kernel itself (under the Pallas interpreter) against K1's
    plain version."""
    monkeypatch.setenv("ROCJPEG_TPU_WAVE", "pallas-interpret")
    assert not _errs(_streams("420", 1, content="gradient")).any()


def _assert_prefix_equal(mine, ref, n):
    for name in ("word_off", "img_base", "mcu_start", "mcu_count",
                 "lane_bank"):
        np.testing.assert_array_equal(getattr(mine, name)[:n],
                                      getattr(ref, name)[:n], err_msg=name)
    # Every word some lane owns. Past the last lane's own words the port's
    # buffer is zero-filled while the JAX packer's comes from a pool and
    # keeps what an earlier pack left there, so the comparison ends at the
    # port's last non-zero word.
    used = int(ref.word_off[n - 1]) + -(-int(ref.max_seg_bits) // 32)
    used = int(np.flatnonzero(mine.dense[:used])[-1]) + 1
    assert used > int(ref.word_off[n - 1])
    np.testing.assert_array_equal(mine.dense[:used], ref.dense[:used])
    for name in ("n_words", "max_seg_bits", "max_lane_syms"):
        assert getattr(mine, name) == getattr(ref, name), name


@pytest.mark.parametrize("css,ri,variants,mcu_range", [
    ("420", 1, None, None),
    ("444", 3, None, None),
    ("422", 2, (0, 1), None),
    ("420", 1, None, (2, 5)),
])
def test_packer_restart_matches_jax(css, ri, variants, mcu_range):
    plist = _streams(css, ri, variants=variants)
    mlist = _port(plist)
    _, bank_of = tables.DeviceScanTables.from_params_banked(mlist)
    tb = tables.GroupGeometry.from_params(mlist[0], 2).total_blocks
    ref = de.pack_segments(plist, tb, dense=True, mcu_range=mcu_range,
                           bank_of=bank_of)
    mine = pack.pack_segments(mlist, tb, mcu_range=mcu_range, bank_of=bank_of)
    n = int(np.count_nonzero(ref.mcu_count))
    assert n and np.count_nonzero(mine.mcu_count) == n
    assert mine.n_lanes % pack.LANE_QUANTUM == 0
    _assert_prefix_equal(mine, ref, n)


@pytest.mark.parametrize("css,mcu_range", [("420", None), ("422", None),
                                           ("420", (3, 9))])
def test_packer_virtual_matches_jax(css, mcu_range):
    plist = _streams(css, 0, w=64, h=48)
    mlist = _port(plist)
    tb = tables.GroupGeometry.from_params(mlist[0], 2).total_blocks
    ref, dc_r, lom_r = de.pack_virtual_segments(plist, tb, 60,
                                                mcu_range=mcu_range)
    mine, dc_m, lom_m = pack.pack_virtual_segments(mlist, tb, 60,
                                                   mcu_range=mcu_range)
    n = int(np.count_nonzero(ref.mcu_count))
    assert n > 2 and np.count_nonzero(mine.mcu_count) == n
    _assert_prefix_equal(mine, ref, n)
    np.testing.assert_array_equal(dc_m[:n], dc_r[:n])
    np.testing.assert_array_equal(lom_m, lom_r)
    geom = tables.GroupGeometry.from_params(mlist[0], 2)
    assert (tables.max_steps_bound(geom, mine)
            == de.max_steps_bound(de.GroupGeometry.from_params(plist[0], 2),
                                  ref))


def test_tables_banked_match_jax():
    plist = _streams("420", 1, seeds=(0, 1, 2), variants=(0, 1, 0))
    mine, bank_m = tables.DeviceScanTables.from_params_banked(_port(plist))
    ref, bank_r = de.DeviceScanTables.from_params_banked(plist)
    np.testing.assert_array_equal(mine.lentab, ref.lentab)
    np.testing.assert_array_equal(mine.values, ref.values)
    np.testing.assert_array_equal(bank_m, bank_r)
    assert mine.n_banks == ref.n_banks == 2


def test_tables_past_four_banks_not_supported():
    # Optimized (per-image) Huffman tables: five distinct table sets.
    plist = [JpegStreamParser().parse(encoder.encode_planes(
        encoder.random_planes("400", 16 + 8 * s, 16, seed=s), "400",
        optimize=True)) for s in range(5)]
    for mod, error, params in ((tables, RocJpegError, _port(plist)),
                               (de, JaxRocJpegError, plist)):
        with pytest.raises(error) as ei:
            mod.DeviceScanTables.from_params_banked(params)
        assert ei.value.status.name == "JPEG_NOT_SUPPORTED"
        assert int(ei.value.status) == -4

