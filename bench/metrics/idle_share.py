"""Share of the profiled stretch (first feed's start to last feed's end)
in which no kernel, copy or set ran on the device (%)."""


def read(ctx):
    if not ctx.feeds or not ctx.tl.device:
        return None
    a, b = ctx.feeds[0][0][0], ctx.feeds[-1][0][1]
    return 100 * (1 - ctx.tl.busy(a, b) / (b - a))
