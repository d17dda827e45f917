"""Share of its roofline the fused scan reaches: the least time of the
profiled feeds' scans (``bench/bounds/fused_scan.py``) over the time the
profiler gives the ``fused_scan`` kernels in those feeds (%)."""


def read(ctx):
    spent = sum(b - a for (s, e), _ in ctx.feeds
                for a, b, name, cat in ctx.tl.kernels_in(s, e)
                if cat == "kernel" and "fused_scan" in name)
    if spent <= 0:
        return None
    least = sum(ctx.bound("fused_scan", k) for _, k in ctx.feeds)
    return 100 * least / spent
