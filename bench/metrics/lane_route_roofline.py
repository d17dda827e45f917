"""Share of its roofline the lane router reaches: the least time of the
profiled feeds' routing (``bench/bounds/lane_route.py``) over the time the
profiler gives the router's kernels in those feeds (%).  The router's
kernels are those of the port's ``csrc/lane_route.cu``, by name."""
import re

#: the kernels ``lane_route_launch`` queues, as the profiler names them
#: (``(anonymous namespace)::probe_kernel(...)``, ``...tile_rank_kernel<0>``);
#: ``fused_scan_kernel`` and ``cea_scan_kernel`` are not ``scan_kernel``
ROUTER = re.compile(r"(?<![\w])(?:probe|tile_rank|scan|compact|walk|finalize)"
                    r"_kernel\b")


def read(ctx):
    spent = sum(b - a for (s, e), _ in ctx.feeds
                for a, b, name, cat in ctx.tl.kernels_in(s, e)
                if cat == "kernel" and ROUTER.search(name))
    if spent <= 0:
        return None
    least = sum(ctx.bound("lane_route", k) for _, k in ctx.feeds)
    return 100 * least / spent
