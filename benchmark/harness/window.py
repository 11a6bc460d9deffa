"""The measured window: closed-loop clients sharing one subject.

Each client takes the next batch of the rotation, parses it into the
subject's stream handles, decodes them, and waits until the call's work
is complete; then it sends the next. A client starts no call once the
window has closed; the calls still running then finish, count as
attempted and are checked, but count in no end-to-end metric. Which
calls keep their outputs for the check after the window is drawn from the
seed: at each of ``keep_at`` (seconds into the window) the next call to
start keeps its outputs; a time no call started after takes the latest
call instead.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import traceback

# How long a call may run past the window's close before the run fails.
JOIN_TIMEOUT_S = 120.0


@dataclasses.dataclass
class Call:
    seq: int
    client: int
    batch: object
    start: float          # host clock, seconds
    parsed: float
    end: float
    flags: list = None    # the call's per-chunk error flags (device)
    error: str = None     # what the call raised, if it raised
    images: list = None   # its outputs, for the calls that keep them


@dataclasses.dataclass
class Window:
    start: float
    end: float            # start + the window's length
    calls: list

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def completed(self) -> list:
        """The calls that completed inside the window, without error."""
        return [c for c in self.calls
                if c.end <= self.end and c.error is None]


def run(subject, batches: list, clients: int, seconds: float,
        keep_at=(), record_function=None, during=None,
        max_calls=None) -> Window:
    """Run the window; ``during(window_start)``, if given, runs on the
    calling thread while the clients run (the traced run's profiler) and
    returns before the window closes. ``max_calls`` (the warm-up) ends it
    after that many calls instead."""
    span = record_function or (lambda name: contextlib.nullcontext())
    lock = threading.Lock()
    go = threading.Event()
    state = {"seq": 0, "keep": sorted(keep_at)}
    calls, clock = [], time.perf_counter
    last = {}
    t = {}

    def client(k: int) -> None:
        go.wait()
        while True:
            with lock:
                now = clock()
                if now >= t["end"] or (max_calls is not None
                                       and state["seq"] >= max_calls):
                    return
                seq = state["seq"]
                state["seq"] += 1
                keep = bool(state["keep"]) and now - t["start"] >= \
                    state["keep"][0]
                if keep:
                    state["keep"].pop(0)
            batch = batches[seq % len(batches)]
            call = Call(seq, k, batch, clock(), 0.0, 0.0)
            try:
                with span("bench.call"):
                    with span("bench.parse"):
                        streams = subject.parse(batch)
                    call.parsed = clock()
                    images, call.flags = subject.decode(batch, streams)
                    subject.wait()
            except Exception:  # a failed call is counted, and the run goes on
                call.error = traceback.format_exc(limit=4)
                images = None
            call.end = clock()
            if keep:
                call.images = images
            elif images is not None:
                # Held until the client's next call completes: a keep time
                # left unclaimed at the close takes the last calls.
                last[k] = (call, images)
            del images
            with lock:
                calls.append(call)

    threads = [threading.Thread(target=client, args=(k,), daemon=True,
                                name=f"bench-client-{k}")
               for k in range(clients)]
    for th in threads:
        th.start()
    t["start"] = clock()
    t["end"] = t["start"] + seconds
    go.set()
    if during is not None:
        during(t["start"])
    while clock() < t["end"] and any(th.is_alive() for th in threads):
        time.sleep(min(0.05, max(t["end"] - clock(), 0)))
    for th in threads:
        th.join(JOIN_TIMEOUT_S)
        if th.is_alive():
            raise RuntimeError(f"a call ran {JOIN_TIMEOUT_S} s past the "
                               "window's close")
    calls.sort(key=lambda c: c.seq)
    spare = sorted(last.values(), key=lambda ci: -ci[0].seq)
    for call, images in spare[:len(state["keep"])]:
        call.images = images
    last.clear()
    return Window(t["start"], t["end"], calls)
