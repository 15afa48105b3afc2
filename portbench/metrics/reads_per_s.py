"""Reads of every batch whose results reached the host inside the window,
over the seconds from the window's start to the last of those
completions: all the work over all the time."""


def read(ctx):
    return ctx.window.reads / ctx.window.seconds
