"""Mean time a batch spent in the executor's ``align`` stage (windowed
GenASM: DC kernel launches and the traceback)."""


def read(ctx):
    return ctx.window.stage_mean_ms("align")
