"""Host time a profiled batch of the align stage's traceback and commit
(`window_tb` and `window_commit` a window step): the `tb` spans'
durations, summed over the steps."""
from portbench.metrics import _spans


def read(ctx):
    return _spans.mean_per_batch(
        ctx, lambda b: 1e3 * sum(s.duration_s for s in b["tb"]))
