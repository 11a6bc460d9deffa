"""The check fails what it must: the control (the reference with the
lower-precision IDCT in the program's place) and faults planted under a
run's timed path, driving the rest of a run on the CPU."""

import pytest

from conftest import make_root


def run_with(tmp_path, mix, make_subject):
    from harness import runner, spec
    cell = spec.cell(f"tiny.{mix}", str(make_root(tmp_path)))
    return runner.run(cell, 2 ** 35 + 9, 1.0, False, device="cpu",
                      make_subject=make_subject)


def port_subject(cls):
    def make(cell, seed, device, fmt):
        return cls(device, fmt)
    return make


def faulty(kind):
    from harness import subject

    class Faulty(subject.Port):
        last = None

        def decode(self, batch, streams):
            if kind == "half":
                n = len(streams) // 2
                images, flags = super().decode(batch, streams[:n])
                # The rest of the batch is left out: its answers repeat
                # those decoded.
                return images + images[:len(streams) - n], flags
            images, flags = super().decode(batch, streams)
            if kind == "stale":
                prev, self.last = self.last, images
                return (prev or images), flags
            if kind == "altered":
                images[-1].channel[0][0, 0] ^= 1
            return images, flags
    return Faulty


def test_sound_run_is_correct(tmp_path):
    from harness import subject
    line = run_with(tmp_path, "rgb", port_subject(subject.Port))
    assert line["correct"] is True


@pytest.mark.parametrize("mix", ["dri0", "rgb"])
def test_the_control_is_not_correct(tmp_path, mix):
    from harness import spec, subject

    def make(cell, seed, device, fmt):
        return subject.Control(spec.reference(cell.bench_dir, cell.config),
                               cell.config, seed, fmt, "ifast")
    line = run_with(tmp_path, mix, make)
    assert line["correct"] is False
    assert line["checks"]["bytes_wrong"]["value"] > 0


@pytest.mark.parametrize("kind", ["stale", "half", "altered"])
def test_faults_under_the_timed_path_are_not_correct(tmp_path, kind):
    line = run_with(tmp_path, "dri0", port_subject(faulty(kind)))
    assert line["correct"] is False


def test_control_numbers_at_a_cells_size_fail(tmp_path):
    import control
    from harness import spec
    cell = spec.cell("tiny.rgb", str(make_root(tmp_path)))
    nums = control.control_numbers(cell, 3)
    from harness import check
    assert check.verdict(nums)[0] is False and nums["bytes_wrong"] > 0
