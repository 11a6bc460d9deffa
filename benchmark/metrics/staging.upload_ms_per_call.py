"""ms a call spends in staging and the upload (the program's rjt.upload
range), over the calls wholly inside the traced slice."""


def read(run):
    t = run.trace
    if t is None or not t.calls_inside or "rjt.upload" not in t.range_us:
        return None
    return t.range_us["rjt.upload"] / 1e3 / t.calls_inside
