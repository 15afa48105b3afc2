"""Seconds from the process's start to the window's: imports and the
CUDA context, the kernels' build (a checkout's first run only), the
deployment and the program's index, the read pool, one warm-up batch."""


def read(ctx):
    return ctx.setup_s
