"""Mean time a batch spent in the linear executor's ``seed_filter``
stage (seeding and the GenASM-DC pre-alignment filter)."""


def read(ctx):
    return ctx.window.stage_mean_ms("seed_filter")
