"""Device time a profiled batch of the linear mapper's pre-alignment
filter (`bitap_search` through the best candidate's text window and
pattern): the `filter` spans' CUDA-event `device_ms`."""
from portbench.metrics import _spans


def read(ctx):
    return _spans.device_ms(ctx, "filter")
