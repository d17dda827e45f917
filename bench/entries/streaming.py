"""Pre-partitioned substreams through ``StreamingVectorEngine.feed_attrs``
over a ``MultiQueryEngine`` (or a ``VectorEngine`` for one query): one
chunk of ``(chunk, lanes)`` events a feed, counts and the hit list back on
the host."""
import numpy as np

from bench import program
from repro_torch.vector import StreamingVectorEngine


class Entry:
    def __init__(self, cfg, traffic, device):
        self.engine = StreamingVectorEngine(program.engine(cfg, device),
                                            cfg["chunk"], cfg["lanes"])
        self.traffic = traffic
        self.pool = None

    def make_pool(self) -> None:
        """The traffic in the program's input form: (chunk, lanes, 1) f32
        type codes a pool chunk."""
        codes = program.type_codes(self.engine.engine,
                                   self.traffic.type_names,
                                   self.traffic.types.device)
        self.pool = [codes[c.long()].unsqueeze(-1).contiguous()
                     for c in self.traffic.types]

    def feed(self, k: int):
        return self.engine.feed_attrs(self.pool[self.traffic.chunk_of(k)])

    @staticmethod
    def n_hits(out) -> int:
        return len(out[1])

    def normalize(self, out):
        """(counts (T, B, Q) int64, hits as ``position * lanes + lane``)."""
        counts, hits = out
        if counts.ndim == 2:
            counts = counts[:, :, None]
        h = np.asarray(hits, dtype=np.int64).reshape(-1, 2)
        return counts, h[:, 0] * self.traffic.lanes + h[:, 1]

    def final(self) -> dict:
        """The program's state to judge: the ring (B, W, S)."""
        return {"ring": self.engine.state}

    def counters(self) -> dict:
        """The program's own counters: scan launches and the ring's plan,
        the engine's library loads, the library's build seconds."""
        from repro_torch.kernels import build, fused_scan
        return {"fused_scan_launches": fused_scan.KERNEL.launches,
                "fused_scan_plan": fused_scan.KERNEL.last_plan,
                "compile_count": self.engine.compile_count,
                "library_loads": build.LIBRARY.loads,
                "library_build_s": build.LIBRARY.build_seconds}

    def checks(self, n_fed: int) -> dict:
        return {}

    def close(self) -> None:
        self.engine = self.pool = None
