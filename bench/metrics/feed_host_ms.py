"""Host time of a feed: the feed span's wall time less the time the
device was busy inside it, mean over the profiled feeds (ms)."""


def read(ctx):
    if not ctx.feeds or not ctx.tl.device:
        return None
    host = [(e - s) - ctx.tl.busy(s, e) for (s, e), _ in ctx.feeds]
    return 1e3 * sum(host) / len(host)
