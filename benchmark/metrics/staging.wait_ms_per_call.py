"""ms a call waits for a staging buffer (the program's rjt.stage_wait
spans, opened only while StagingPool.acquire blocks on a buffer's copy or
for a buffer to come back), over the calls wholly inside the traced slice;
0.0 where the program's rjt.decode spans are there and no wait happened."""


def read(run):
    t = run.trace
    if t is None or not t.calls_inside or "rjt.decode" not in t.range_us:
        return None
    return t.range_us.get("rjt.stage_wait", 0.0) / 1e3 / t.calls_inside
