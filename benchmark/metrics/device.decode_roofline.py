"""Share of the peak memory bandwidth that the whole decode reaches: the
bytes any decoder of these streams must move (the scans in, the format's
output out; harness.roofline) for the calls completed in the traced
slice, over the device's busy time there (the union of every device
interval), in %."""

from harness import roofline


def read(run):
    t = run.trace
    if t is None or not t.completed or not t.busy_us:
        return None
    return roofline.share(run.bytes_per_call["decode"] * t.completed,
                          t.busy_us / 1e6, run.peak_bytes_per_s)
