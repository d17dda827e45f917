"""The engine's peak device memory over the window: the most allocated
at once, less the traffic the harness itself holds (GB)."""


def read(ctx):
    return ctx.peak_bytes / 1e9
