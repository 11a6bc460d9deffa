"""Share of the peak memory bandwidth that K1, the entropy decode,
reaches: the bytes its calls must move (harness.roofline, from the streams' shapes) over its
kernels' device time in the traced slice, in %. The calls are those that
completed in the slice."""

from harness import roofline

KERNELS = ("wave_kernel", "wave_prologue_kernel")


def read(run):
    t = run.trace
    if t is None or not t.completed:
        return None
    us = t.device_us(*KERNELS)
    if not us:
        return None
    return roofline.share(run.bytes_per_call["wave"] * t.completed,
                          us / 1e6, run.peak_bytes_per_s)
