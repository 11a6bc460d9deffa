"""95th percentile over every call completed in the window of the time
from the call's start (its parse included) to its outputs being complete
on the device, in ms (host clock)."""

import statistics


def read(run):
    ms = [(c.end - c.start) * 1e3 for c in run.window.completed()]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=100, method="inclusive")[94]
