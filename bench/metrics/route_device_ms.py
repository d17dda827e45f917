"""Device time a feed of every kernel in the feed span other than the
scan: the lane router, the scatter to lanes, the relabelling and the
stats (ms, mean over the profiled feeds)."""


def read(ctx):
    if not ctx.feeds:
        return None
    total, seen = 0.0, False
    for (s, e), _ in ctx.feeds:
        for a, b, name, cat in ctx.tl.kernels_in(s, e):
            if cat == "kernel" and "fused_scan" not in name:
                total += b - a
                seen = True
    return 1e3 * total / len(ctx.feeds) if seen else None
