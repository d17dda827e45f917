"""Host time of handing a chunk to the device: the wall time of the
program's ``streaming.device_step`` span (the pipeline's checks, the ring
plan, the launch; the scan itself runs on after it), mean over the
profiled feeds (ms)."""


def read(ctx):
    spans = ctx.tl.spans.get("streaming.device_step")
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
