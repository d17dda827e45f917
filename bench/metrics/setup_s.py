"""Process start to the first timed feed: imports, the kernel library,
the engine, the traffic and the warm-up feeds (s)."""


def read(ctx):
    return ctx.setup_s
