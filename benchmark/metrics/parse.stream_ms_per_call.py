"""ms a call spends parsing its streams' headers, from the program's own
rjt.parse spans (one a stream, in JpegStream.parse), over the calls wholly
inside the traced slice."""


def read(run):
    t = run.trace
    if t is None or not t.calls_inside or "rjt.parse" not in t.range_us:
        return None
    return t.range_us["rjt.parse"] / 1e3 / t.calls_inside
