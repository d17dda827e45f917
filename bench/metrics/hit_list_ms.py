"""Host time of the hit list: the wall time of the program's
``streaming.hit_list`` span (the counts as int64, ``np.nonzero`` and the
``(position, lane)`` list), mean over the profiled feeds (ms)."""


def read(ctx):
    spans = ctx.tl.spans.get("streaming.hit_list")
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
