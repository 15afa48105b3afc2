"""Share of the profiled span in which the card idled inside the align
stage's traceback: the gaps between the merged device records (as the
harness's breakdown finds them) that fall inside the `tb` spans, mapped
onto the profiler's epoch clock."""
import numpy as np

from portbench.metrics import _spans


def read(ctx):
    got = _spans.batches(ctx)
    if got is None:
        return None
    offset, bs = got
    gaps, end = [], None
    for _, a, b in sorted(ctx.profile.records, key=lambda r: r[1]):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    if not gaps:
        return 0.0
    ga, gb = np.array(gaps, dtype=np.int64).T
    idle_ns = 0
    for s in (s for b in bs for s in b["tb"]):
        t0, t1 = round(s.t_start * 1e9) + offset, round(s.t_end * 1e9) + offset
        idle_ns += int(np.clip(np.minimum(gb, t1) - np.maximum(ga, t0), 0, None).sum())
    return 100.0 * idle_ns / 1e9 / ctx.profile.span_s
