"""One interleaved keyed stream through
``PartitionedStreamingEngine.feed_keyed``: lane routing, scatter, the
fused scan at per-lane positions and the relabelling back to global
positions, one chunk a feed; counts and hits back on the host."""
import numpy as np
import torch

from bench import program
from repro_torch.core.partition import NULL_KEY_HASH
from repro_torch.vector import PartitionedStreamingEngine


class Entry:
    def __init__(self, cfg, traffic, device):
        self.engine = PartitionedStreamingEngine(
            program.engine(cfg, device), tuple(cfg["key_attrs"]),
            cfg["chunk"], cfg["lanes"], lane_cap=cfg["lane_cap"])
        self.traffic = traffic
        self.pool = None

    def make_pool(self) -> None:
        """The traffic in the program's input form: (chunk, 1) f32 type
        codes and (chunk,) int32 key hashes (NULL where no key)."""
        tr = self.traffic
        dev = tr.types.device
        codes = program.type_codes(self.engine.engine, tr.type_names, dev)
        table = torch.cat([tr.key_hashes,
                           torch.tensor([NULL_KEY_HASH], device=dev)])
        # int64 hash values → their int32 bit patterns
        bits = torch.where(table >= 1 << 31, table - (1 << 32),
                           table).to(torch.int32)
        self.pool = [(codes[t.long()].unsqueeze(-1).contiguous(),
                      bits[torch.where(k < 0, tr.n_keys, k).long()])
                     for t, k in zip(tr.types, tr.keys)]

    def feed(self, k: int):
        attrs, keys = self.pool[self.traffic.chunk_of(k)]
        return self.engine.feed_keyed(attrs, keys)

    @staticmethod
    def n_hits(out) -> int:
        return len(out[1])

    def normalize(self, out):
        """(counts (T, Q) int64, hits as global positions)."""
        counts, hits = out
        if counts.ndim == 1:
            counts = counts[:, None]
        return counts, np.asarray(hits, dtype=np.int64)

    def final(self) -> dict:
        """The program's state to judge: the ring (L, W, S) and the hash
        of the key each lane holds."""
        st = self.engine.state
        keys = st["lane_keys"].view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        return {"ring": st["C"], "lane_keys": keys}

    def counters(self) -> dict:
        """The program's own counters: scan and router launches, the
        ring's plan, the engine's library loads, the library's build
        seconds, the routing stats."""
        from repro_torch.kernels import build, fused_scan, lane_route
        return {"fused_scan_launches": fused_scan.KERNEL.launches,
                "lane_route_launches": lane_route.KERNEL.launches,
                "fused_scan_plan": fused_scan.KERNEL.last_plan,
                "compile_count": self.engine.compile_count,
                "library_loads": build.LIBRARY.loads,
                "library_build_s": build.LIBRARY.build_seconds,
                "stats": vars(self.engine.stats).copy()}

    def checks(self, n_fed: int) -> dict:
        """Routing outcomes: nothing spills or is evicted, and every
        event with a key is routed."""
        st = self.engine.stats
        tr = self.traffic
        keyed = int(tr.key_events_before(n_fed).sum())
        return {"spilled_or_evicted": (st.spilled_table + st.spilled_capacity
                                       + st.evicted_lanes, 0),
                "routed_wrong": (abs(st.routed - keyed), 0)}

    def close(self) -> None:
        self.engine = self.pool = None
