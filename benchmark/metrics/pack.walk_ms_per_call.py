"""ms a call spends in the DRI=0 index walk (the program's rjt.walk
range), over the calls wholly inside the traced slice."""


def read(run):
    t = run.trace
    if t is None or not t.calls_inside or "rjt.walk" not in t.range_us:
        return None
    return t.range_us["rjt.walk"] / 1e3 / t.calls_inside
