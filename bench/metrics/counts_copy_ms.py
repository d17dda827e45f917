"""Device time of the counts' copy to the host: the copies that start
inside the program's ``streaming.counts_to_host`` span, mean over the
profiled feeds (ms)."""


def read(ctx):
    spans = ctx.tl.spans.get("streaming.counts_to_host")
    if not spans:
        return None
    copies = [b - a for s, e in spans
              for a, b, _, cat in ctx.tl.kernels_in(s, e)
              if cat == "gpu_memcpy"]
    if not copies:
        return None
    return 1e3 * sum(copies) / len(spans)
