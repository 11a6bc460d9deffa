"""ms a call spends in the session API's own code (grouping, chunking,
dispatch, result assembly): the program's rjt.decode span less its direct
children, over the calls wholly inside the traced slice."""

# The spans opened directly inside rjt.decode; rjt.walk and rjt.stage_wait
# lie inside rjt.pack or rjt.upload, so they are not subtracted again.
CHILDREN = ("rjt.throttle", "rjt.pack", "rjt.upload", "rjt.wave",
            "rjt.transform", "rjt.epilogue", "rjt.host_entropy",
            "rjt.error_check")


def read(run):
    t = run.trace
    if t is None or not t.calls_inside or "rjt.decode" not in t.range_us:
        return None
    inner = sum(t.range_us.get(name, 0.0) for name in CHILDREN)
    return (t.range_us["rjt.decode"] - inner) / 1e3 / t.calls_inside
