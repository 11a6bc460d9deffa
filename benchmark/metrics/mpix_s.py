"""Decoded megapixels of every call completed in the window, over the
window's seconds (host clock)."""


def read(run):
    w = run.window
    return sum(c.batch.pixels for c in w.completed()) / 1e6 / w.seconds
