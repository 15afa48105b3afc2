"""Closed-loop arrivals for bulk mapping: the next batch is due as soon
as the last one's results reached the host.  The window holds every
batch that completes inside ``seconds``; one that completes after it is
left out, with its time."""
from __future__ import annotations

import time


def run(step, win, seconds: float) -> None:
    """Drive ``step`` (one batch through the timed path) from ``win.t0``
    for ``seconds``, recording each batch that completes in time."""
    t_end = win.t0 + seconds
    while time.perf_counter() < t_end:
        rec = step()
        if rec["done"] > t_end:
            break
        win.record(rec)
