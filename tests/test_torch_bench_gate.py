"""The port's bench regression gate, ``rocjpeg_tpu_torch.tools.bench.
check_regressions``: the cases of ``tests/test_bench_gate.py`` against the
port's own records.

The gate ratchets against the previous record and the best one: a chain of
0.93x declines never trips a previous-record-only gate. It reads only the
port's records, ``BENCH_TORCH_r<N>.json``, and of those only the ones taken
on the card the result was (the same name and power limit): a TPU record
(``BENCH_r<N>.json``) or a record of another card or limit is never
compared.
"""

import json

import pytest

from rocjpeg_tpu_torch.tools import bench

CARD = {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W",
        "count": 1}


def _write(d, name, headline, dri0=1000.0, device=CARD):
    rec = {"value": headline, "device": device}
    if dri0 is not None:
        rec["dri0_mpix_s"] = dri0
    (d / name).write_text(json.dumps(rec))


def _result(headline, dri0=None, device=CARD):
    res = {"value": headline, "device": device}
    if dri0 is not None:
        res["dri0_mpix_s"] = dri0
    return res


# (headlines of the records r1, r2, ... (dri0 1000 each), the result's
# headline and dri0, whether the gate trips)
CASES = {
    "passes-on-parity": ([7000.0, 6900.0], 6950.0, 1000.0, False),
    "trips-vs-previous-record": ([7000.0], 5000.0, 1000.0, True),
    # Each record within the previous-record tolerance (0.93x steps), but
    # 0.93x r3 = 5630 = 0.80x the best: below 0.85x the best, it trips.
    "trips-on-slow-ratchet-vs-best": ([7000.0, 6510.0, 6054.0], 5630.0,
                                      1000.0, True),
    "improvement-never-trips": ([7000.0], 7500.0, 1400.0, False),
    # A result missing some legs does not crash and gates the legs present.
    "missing-legs-pass": ([7000.0], 6900.0, None, False),
    "missing-legs-trip": ([7000.0], 100.0, None, True),
    "no-history-is-silent": ([], 1.0, None, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gate(tmp_path, case):
    records, headline, dri0, trips = CASES[case]
    for n, value in enumerate(records, 1):
        _write(tmp_path, f"BENCH_TORCH_r{n:02d}.json", value,
               dri0=743.0 if case == "improvement-never-trips" else 1000.0)
    assert bench.check_regressions(_result(headline, dri0),
                                   records_dir=str(tmp_path)) is trips


def test_gate_orders_records_by_number(tmp_path, capsys):
    """r10 comes after r9: the previous record is the highest number."""
    _write(tmp_path, "BENCH_TORCH_r9.json", 5000.0)
    _write(tmp_path, "BENCH_TORCH_r10.json", 4000.0)
    assert not bench.check_regressions(_result(4000.0),
                                       records_dir=str(tmp_path),
                                       best_threshold=0.5)
    assert "vs BENCH_TORCH_r10.json" in capsys.readouterr().err


def test_gate_never_reads_a_tpu_record(tmp_path):
    """The JAX package's records (``BENCH_r<N>.json``) are the TPU's: one
    with a rate the result is far below, even one that names this card, is
    not compared."""
    _write(tmp_path, "BENCH_r05.json", 100000.0)
    _write(tmp_path, "BENCH_TORCH_r01.json", 7000.0)
    assert not bench.check_regressions(_result(6950.0, 1000.0),
                                       records_dir=str(tmp_path))
    (tmp_path / "BENCH_TORCH_r01.json").unlink()
    assert not bench.check_regressions(_result(6950.0, 1000.0),
                                       records_dir=str(tmp_path))


OTHER = {
    "another-card": dict(CARD, name="NVIDIA H100 PCIe"),
    "another-power-limit": dict(CARD, power_limit="400.00 W"),
    "the-cpu": "cpu",
}


@pytest.mark.parametrize("case", sorted(OTHER))
def test_gate_ignores_records_of_another_card(tmp_path, case, capsys):
    _write(tmp_path, "BENCH_TORCH_r01.json", 7000.0)
    _write(tmp_path, "BENCH_TORCH_r02.json", 90000.0, device=OTHER[case])
    # Held to r01 alone: 6950 passes; against r02 it would trip.
    assert not bench.check_regressions(_result(6950.0, 1000.0),
                                       records_dir=str(tmp_path))
    assert "BENCH_TORCH_r02.json is of" in capsys.readouterr().err
    # And a result of that other card is held to its own record alone.
    assert bench.check_regressions(_result(6950.0, 1000.0,
                                           device=OTHER[case]),
                                   records_dir=str(tmp_path))
