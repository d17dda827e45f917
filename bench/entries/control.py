"""The control of a cell's comparison: the configuration's plain
reference, computed in the precision below the one the configuration
states (bfloat16 for float32), in the program's place.  ``run.py``
drives it as it drives the program (``run_cell(..., entry="control")``),
and it has to come out as not correct."""
from types import SimpleNamespace

import torch

from bench import run as bench_run

#: the nearest precision below each one a configuration states
LOWER = {"float64": torch.float32, "float32": torch.bfloat16}


class Entry:
    def __init__(self, cfg, traffic, device):
        self.ref = bench_run.load("reference", cfg["reference"])
        self.dtype = LOWER[cfg["precision"]]
        self.run = SimpleNamespace(cfg=cfg, traffic=traffic)
        self.fill = traffic.fill_feeds(cfg["window"])
        self.cache = {}
        self.n_fed = 0

    def make_pool(self) -> None:
        pass

    def feed(self, k: int):
        """Feed ``k``'s counts and hit list as the reference gives them in
        the lower precision; feeds past the fill with the same pool chunk
        have the same history, so their counts are worked out once."""
        key = (k % self.run.traffic.pool_chunks if k >= self.fill
               else ("set_up", k))
        if key not in self.cache:
            self.cache[key] = self.ref.expected(self.run, k, self.dtype)
        counts = self.cache[key]
        self.n_fed = k + 1
        return counts, self.ref.hits_of(self.run, k, counts)

    @staticmethod
    def n_hits(out) -> int:
        return len(out[1])

    @staticmethod
    def normalize(out):
        counts, hits = out
        return counts.cpu().numpy(), hits

    def final(self) -> dict:
        """The ring after the last feed, in the lower precision; keyed
        traffic puts key ``b`` in lane ``b``."""
        tr, cfg = self.run.traffic, self.run.cfg
        W = cfg["window"] + 1
        if tr.layout == "keyed":
            return {"ring": self.ref.keyed_ring(tr, cfg, self.n_fed, W,
                                                self.dtype),
                    "lane_keys": tr.key_hashes}
        return {"ring": self.ref.lane_ring(tr, cfg, self.n_fed, W,
                                           self.dtype)}

    def counters(self) -> dict:
        return {}

    def checks(self, n_fed: int) -> dict:
        return {}

    def close(self) -> None:
        self.cache = {}
