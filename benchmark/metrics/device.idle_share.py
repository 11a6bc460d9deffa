"""Share of the traced slice in which nothing ran on the device, in %."""


def read(run):
    t = run.trace
    if t is None or not t.seconds:
        return None
    return 100.0 * (1.0 - t.busy_us / 1e6 / t.seconds)
