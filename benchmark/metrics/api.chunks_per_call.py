"""Chunks a call is decoded in by the session API: K1 launches in the
window (the program's ``kernels.wave.launches`` counter) over the calls
the window started."""


def read(run):
    calls = len(run.window.calls)
    if not calls or not run.launches:
        return None
    return run.launches / calls
