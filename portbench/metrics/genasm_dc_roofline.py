"""The GenASM-DC kernels' share of their roofline over the profiled
batches: the card's least time for the windows launched
(`portbench.work.genasm_dc`) over the kernels' device time."""
from portbench import work

KERNELS = ("dc_wave",)


def read(ctx):
    return ctx.roofline("genasm_dc", KERNELS, work.genasm_dc)
