"""Share of the peak memory bandwidth that K2, the dequantisation and
IDCT, reaches: the bytes its calls must move (harness.roofline, from the streams' shapes) over its
kernels' device time in the traced slice, in %. The calls are those that
completed in the slice."""

from harness import roofline

KERNELS = ("transform_kernel",)


def read(run):
    t = run.trace
    if t is None or not t.completed:
        return None
    us = t.device_us(*KERNELS)
    if not us:
        return None
    return roofline.share(run.bytes_per_call["transform"] * t.completed,
                          us / 1e6, run.peak_bytes_per_s)
