"""Share of the profiled batches' span in which no kernel, copy or
memset ran on the card (the union of the profiler's device records)."""


def read(ctx):
    if ctx.profile is None:
        return None
    return 100.0 * (1.0 - ctx.profile.busy_s / ctx.profile.span_s)
