"""The whole feed's share of the card's peak: the least time the feed's
own work needs (the sum of the cell's ``bounds``: scan, and routing where
there is one), whatever kernels run, over the mean feed wall time (%)."""


def read(ctx):
    if not ctx.feeds or not ctx.tl.device:
        return None
    least = sum(ctx.bound(b, k) for _, k in ctx.feeds
                for b in ctx.cell["bounds"])
    wall = sum(e - s for (s, e), _ in ctx.feeds)
    return 100 * least / wall
