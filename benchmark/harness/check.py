"""The comparison that decides ``correct``.

After the window has closed and the device's peak memory has been read,
the outputs that the calls drawn from the seed kept are brought to the
host, every other output is freed, and each image of those calls is held
against the configuration's plain reference, which decodes the same
image from the coefficients the benchmark itself drew. The numbers
compared, each with its limit:

- ``bytes_wrong``: output bytes that differ from the reference's;
- ``max_abs_diff``: the largest difference of one output byte;
- ``shape_mismatches``: images whose channels are missing or of another
  shape than the reference's;
- ``failed_calls``: calls of the window that raised or whose device
  error flags are set (every call, not only the kept ones);
- ``images_checked``: at least one image was compared.

The decode is exact (int32 fixed point end to end), so every limit on a
difference is 0.
"""

from __future__ import annotations

import os

import numpy as np

LIMITS = {"bytes_wrong": 0, "max_abs_diff": 0, "shape_mismatches": 0,
          "failed_calls": 0}
MIN_IMAGES_CHECKED = 1

_refs = {}


def _reference(path: str):
    """The reference module at ``path``, loaded once a worker."""
    if path not in _refs:
        from . import spec
        name = os.path.basename(path)[:-3]
        _refs[path] = spec.load_module(path, "bm_reference_" + name)
    return _refs[path]


def reference_path(bench_dir: str, config: dict) -> str:
    return os.path.join(bench_dir, "references", config["reference"] + ".py")


def compare_job(args) -> tuple:
    """(bytes_wrong, max_abs_diff, shape_mismatch) of one image's output
    channels against the reference's (runs in a worker)."""
    path, config, seed, im, fmt, idct, got = args
    want = _reference(path).decode(config, seed, im.batch, im.slot, im.width,
                                   im.height, fmt, idct)
    if got is None or len(got) != len(want) or any(
            g.shape != w.shape for g, w in zip(got, want)):
        return 0, 0, 1
    wrong = sum(int(np.count_nonzero(g != w)) for g, w in zip(got, want))
    diff = max(int(np.abs(g.astype(np.int16) - w).max()) if g.size else 0
               for g, w in zip(got, want))
    return wrong, diff, 0


def control_job(args) -> tuple:
    """:func:`compare_job` of the reference decoded with the control's
    IDCT in the program's place (runs in a worker)."""
    path, config, seed, im, fmt, control_idct = args
    got = _reference(path).decode(config, seed, im.batch, im.slot, im.width,
                                  im.height, fmt, control_idct)
    return compare_job((path, config, seed, im, fmt, "islow", got))


def summary(res: list, failed: int) -> dict:
    """The compared numbers from per-image (bytes_wrong, max_abs_diff,
    shape_mismatch) results."""
    return {"bytes_wrong": sum(r[0] for r in res),
            "max_abs_diff": max((r[1] for r in res), default=0),
            "shape_mismatches": sum(r[2] for r in res),
            "failed_calls": failed,
            "images_checked": len(res),
            "images_wrong": sum(1 for r in res if r[0] or r[2])}


def kept_outputs(window, subject) -> list:
    """(image, host channels) of every image of the calls that kept their
    outputs; the device outputs are dropped as they are copied."""
    jobs = []
    for call in window.calls:
        if call.images is None:
            continue
        host = subject.to_host(call.images)
        call.images = None
        for k, im in enumerate(call.batch.images):
            jobs.append((im, host[k] if k < len(host) else None))
    return jobs


def numbers(pool, bench_dir: str, config: dict, seed: int, fmt: str,
            outputs: list, failed: int, idct: str = "islow") -> dict:
    """The compared numbers of a run."""
    path = reference_path(bench_dir, config)
    res = pool.map(compare_job, [(path, config, seed, im, fmt, idct, got)
                                 for im, got in outputs], chunksize=1)
    return summary(res, failed)


def verdict(nums: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) in the order printed."""
    checks = {k: {"value": nums[k], "limit": LIMITS[k]} for k in LIMITS}
    checks["images_checked"] = {"value": nums["images_checked"],
                                "limit": MIN_IMAGES_CHECKED}
    ok = all(nums[k] <= LIMITS[k] for k in LIMITS) and \
        nums["images_checked"] >= MIN_IMAGES_CHECKED
    return ok, checks


def describe(checks: dict) -> list:
    """One line a number: its name, value and limit."""
    out = []
    for k, c in checks.items():
        rel = ">=" if k == "images_checked" else "<="
        out.append(f"check {k} {c['value']} limit {rel} {c['limit']}")
    return out
