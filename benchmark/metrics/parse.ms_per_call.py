"""ms a call spends building its JpegStreams (the parse layer), from the
harness's own span around it, over the calls wholly inside the traced
slice."""


def read(run):
    t = run.trace
    if t is None or not t.calls_inside or "bench.parse" not in t.range_us:
        return None
    return t.range_us["bench.parse"] / 1e3 / t.calls_inside
