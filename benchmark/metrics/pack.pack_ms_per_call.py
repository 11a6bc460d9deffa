"""ms a call spends in the pack less its index walk (the program's
rjt.pack range less the rjt.walk ranges inside it), over the calls wholly
inside the traced slice."""


def read(run):
    t = run.trace
    if t is None or not t.calls_inside or "rjt.pack" not in t.range_us:
        return None
    return (t.range_us["rjt.pack"] - t.range_us.get("rjt.walk", 0.0)) \
        / 1e3 / t.calls_inside
