"""A configuration, a mix and a metric are found by name from new files
and entries alone: no file of the benchmark is edited."""

import json

from conftest import make_root


def test_new_config_mix_and_metric_are_found(tmp_path):
    def extra(root, bench):
        (root / "benchmark/mixes/nv12x1.json").write_text(json.dumps(
            {"name": "nv12x1", "loop": "closed", "clients": 1,
             "format": "native", "restart_mcus": 2, "why": "test"}))
        (root / "benchmark/metrics/test.calls.py").write_text(
            "def read(run):\n    return float(len(run.window.calls))\n")
        bench["workloads"].append({"name": "tiny.nv12x1", "config": "tiny",
                                   "traffic": "nv12x1", "chips": 1,
                                   "why": "test"})
        bench["end_to_end"].append({"name": "test.calls", "unit": "count",
                                    "better": "higher", "bound": 0.25,
                                    "source": "host_clock",
                                    "workloads": ["tiny.nv12x1"]})

    root = make_root(tmp_path, extra)
    from harness import runner, spec
    cell = spec.cell("tiny.nv12x1", str(root))
    assert cell.mix["restart_mcus"] == 2 and cell.config["name"] == "tiny"
    line = runner.run(cell, 5, 1.0, False, device="cpu")
    assert line["correct"] is True
    assert line["metrics"]["test.calls"]["value"] >= 1
    other = spec.cell("tiny.dri0", str(root))
    assert "test.calls" not in {m["name"] for m in other.end_to_end}
