"""Device time a profiled batch of the GenASM-DC calls of the align
stage's window steps: the `dc` spans' CUDA-event `device_ms`, summed
over the steps."""
from portbench.metrics import _spans


def read(ctx):
    return _spans.device_ms(ctx, "dc")
