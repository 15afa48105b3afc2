"""Device time a profiled batch of the linear mapper's seeding
(`seed_candidates`): the `seed` spans' CUDA-event `device_ms`."""
from portbench.metrics import _spans


def read(ctx):
    return _spans.device_ms(ctx, "seed")
