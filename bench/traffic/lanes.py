"""Pre-partitioned substreams: every lane draws its event types
uniformly from the cell's ``types``, independently of the other lanes.

The pool holds ``pool_chunks`` chunks of ``(chunk, lanes)`` type indices,
made on the device from the seed in one call; feed ``k`` sends chunk
``k % pool_chunks``, so the stream each lane sees is the pool cycled.
"""
import math

import torch


class Traffic:
    layout = "lanes"

    def __init__(self, params: dict, cfg: dict, seed: int, device):
        self.type_names = list(params["types"])
        self.pool_chunks = int(params["pool_chunks"])
        self.chunk, self.lanes = int(cfg["chunk"]), int(cfg["lanes"])
        self.events_per_feed = self.chunk * self.lanes
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        #: (pool_chunks, chunk, lanes) uint8 indices into ``type_names``
        self.types = torch.randint(
            0, len(self.type_names),
            (self.pool_chunks, self.chunk, self.lanes), generator=g,
            device=device, dtype=torch.uint8)

    def chunk_of(self, k: int) -> int:
        return k % self.pool_chunks

    def fill_feeds(self, window: int) -> int:
        """Feeds after which every lane's window is full."""
        return math.ceil((window + 1) / self.chunk)

    def lane_types(self, feeds) -> torch.Tensor:
        """``(len(feeds) * chunk, lanes)`` type indices of those feeds, in
        stream order."""
        return torch.cat([self.types[self.chunk_of(k)] for k in feeds])
