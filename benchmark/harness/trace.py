"""The traced run: a bounded slice of the window under ``torch.profiler``,
reduced in memory to what the per-layer readers and the breakdown need.
No trace file is written.

The slice is the span of a ``bench.slice`` range on the harness's main
thread. Every thread is profiled, so the program's ``rjt.*`` ranges in
the clients' threads and the harness's ``bench.*`` ranges are seen; a
range belongs to the ``bench.call`` range that holds it on its thread.
Device intervals are clipped to the slice.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

import numpy as np

SLICE = "bench.slice"
CALL = "bench.call"
BIN_US = 250.0  # resolution of the idle-gap attribution


def profiler():
    """A profiler of host and device, over every thread of the process."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, experimental_config=_ExperimentalConfig(
        profile_all_threads=True))


def _union(intervals) -> list:
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


@dataclasses.dataclass
class Trace:
    slice_us: tuple           # (start, end)
    device: list              # (name, start, end), clipped to the slice
    calls_inside: int         # bench.call ranges wholly inside the slice
    completed: int            # bench.call ranges that end inside the slice
    range_us: dict            # name -> us, summed over the calls inside
    busy_us: float            # union of the device intervals
    idle_by_range: dict       # innermost host range -> idle device us

    @property
    def seconds(self) -> float:
        return (self.slice_us[1] - self.slice_us[0]) / 1e6

    def device_us(self, *patterns) -> float:
        """Device time of the operations whose name holds a pattern."""
        return sum(e - s for n, s, e in self.device
                   if any(p in n for p in patterns))

    def device_ops(self) -> dict:
        out = collections.Counter()
        for n, s, e in self.device:
            out[n] += e - s
        return out


def reduce(events) -> Trace:
    """A :class:`Trace` from ``profile.events()``."""
    from torch.autograd import DeviceType
    host, device = [], []
    for ev in events:
        tr = ev.time_range
        ranged = ev.name.startswith(("rjt.", "bench."))
        if ev.device_type == DeviceType.CUDA:
            # A host range's mirror on the device's timeline is no device
            # operation.
            if not ranged:
                device.append((ev.name, tr.start, tr.end))
        elif ranged:
            host.append((ev.name, ev.thread, tr.start, tr.end))
    sl = [(s, e) for n, _, s, e in host if n == SLICE]
    if not sl:
        raise RuntimeError("the trace holds no bench.slice range")
    s0, s1 = sl[0]
    device = [(n, max(s, s0), min(e, s1)) for n, s, e in device
              if e > s0 and s < s1]

    by_thread = collections.defaultdict(list)
    for n, th, s, e in host:
        if n != SLICE:
            by_thread[th].append((s, e, n))
    calls_inside, completed = 0, 0
    totals = collections.Counter()
    for th, rs in by_thread.items():
        rs.sort()
        calls = [(s, e) for s, e, n in rs if n == CALL]
        completed += sum(1 for s, e in calls if s0 < e <= s1)
        inside = [(s, e) for s, e in calls if s >= s0 and e <= s1]
        calls_inside += len(inside)
        starts = [s for s, _ in inside]
        for s, e, n in rs:
            if n == CALL:
                continue
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and e <= inside[i][1]:
                totals[n] += e - s

    busy = _union((s, e) for _, s, e in device)
    busy_us = sum(e - s for s, e in busy)
    return Trace((s0, s1), device, calls_inside, completed, dict(totals),
                 busy_us, _idle_by_range(s0, s1, busy, by_thread))


def _idle_by_range(s0, s1, busy, by_thread) -> dict:
    """Idle device time by the innermost host range open on each thread,
    split evenly between the threads that have one open ("none" where no
    thread has)."""
    nb = max(1, int((s1 - s0) // BIN_US) + 1)
    idle = np.full(nb, BIN_US)
    for lo, hi in busy:
        a, b = (lo - s0) / BIN_US, (hi - s0) / BIN_US
        i0, i1 = int(a), min(int(b), nb - 1)
        if i0 == i1:
            idle[i0] -= hi - lo
        else:
            idle[i0] -= (i0 + 1 - a) * BIN_US
            idle[i1] -= (b - i1) * BIN_US
            idle[i0 + 1:i1] = 0
    idle = np.maximum(idle, 0)
    names = ["none"]
    index = {}
    layers = []
    for th, rs in by_thread.items():
        lab = np.zeros(nb, np.int64)
        for s, e, n in rs:  # in start order: an inner range paints last
            if n not in index:
                index[n] = len(names)
                names.append(n)
            i0 = max(int((s - s0) // BIN_US), 0)
            i1 = min(int((e - s0) // BIN_US), nb - 1)
            if i1 >= i0:
                lab[i0:i1 + 1] = index[n]
        layers.append(lab)
    if not layers:
        return {"none": float(idle.sum())}
    lab = np.stack(layers)
    active = (lab > 0).sum(0)
    share = np.where(active > 0, idle / np.maximum(active, 1), 0.0)
    out = collections.Counter()
    out["none"] += float(idle[active == 0].sum())
    for row in lab:
        sums = np.bincount(row, weights=share, minlength=len(names))
        for k in np.flatnonzero(sums[1:]) + 1:
            out[names[k]] += float(sums[k])
    return dict(out)


def breakdown(tr: Trace) -> dict:
    """The ten device operations that took most time and the ten host
    ranges most idle device time fell in, in seconds."""
    ops = sorted(tr.device_ops().items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(tr.idle_by_range.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": [[n, us / 1e6] for n, us in gaps]}
