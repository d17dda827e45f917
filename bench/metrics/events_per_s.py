"""Events fed in the window over all the window's time, counts and hit
lists back on the host included (events/s)."""


def read(ctx):
    return ctx.events / ctx.window_s
