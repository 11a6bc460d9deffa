"""ms a call waits in the session API's in-flight throttle (the program's
rjt.throttle spans, opened only while Decoder._acquire_slot blocks), over
the calls wholly inside the traced slice; 0.0 where the program's
rjt.decode spans are there and no wait happened."""


def read(run):
    t = run.trace
    if t is None or not t.calls_inside or "rjt.decode" not in t.range_us:
        return None
    return t.range_us.get("rjt.throttle", 0.0) / 1e3 / t.calls_inside
