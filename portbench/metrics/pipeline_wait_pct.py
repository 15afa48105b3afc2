"""Share of the window the mapper waited on the read pipeline: the
benchmark's span around each ``next()`` on the `Prefetcher`."""


def read(ctx):
    return 100.0 * sum(ctx.window.waits) / ctx.window.seconds
