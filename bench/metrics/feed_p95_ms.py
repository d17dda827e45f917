"""95th percentile over every feed of the window of the time from handing
the chunk in to its counts and hits on the host (ms)."""
import numpy as np


def read(ctx):
    return 1e3 * float(np.percentile(ctx.latencies, 95))
