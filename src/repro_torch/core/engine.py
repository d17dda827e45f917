"""CORE's evaluation algorithm (paper §5.3, Algorithm 1).

Incrementally maintains (1) a tECS representing all open complex events and
(2) the set of active det-CEA states, as an insertion-ordered hash table
``T: det-state → union-list``.  Per event the update cost is
``O(|Q|·|Δ|)`` — constant in data complexity, independent of stream length,
window size, and number of partial matches.  At every position ``j`` the set
``⟦A⟧ε_j(S)`` is enumerated from the tECS with output-linear delay
(Algorithm 2 in :mod:`repro_torch.core.tecs`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from .cea import CEA, DetCEA
from .events import ComplexEvent, Event
from .tecs import (TECS, Node, UnionList, enumerate_node, new_ulist,
                   ulist_insert, ulist_max, ulist_merge)


@dataclass
class WindowSpec:
    """``WITHIN`` clause: count-based (events) or time-based (timestamps)."""

    kind: str = "none"          # 'none' | 'events' | 'time'
    size: float = 0.0
    time_attr: Optional[str] = None  # read timestamps from this attribute

    @staticmethod
    def events(n: int) -> "WindowSpec":
        return WindowSpec("events", float(n))

    @staticmethod
    def time(seconds: float, attr: Optional[str] = None) -> "WindowSpec":
        return WindowSpec("time", seconds, attr)


@dataclass
class EngineStats:
    events: int = 0
    matches: int = 0
    nodes: int = 0
    active_states: int = 0
    det_states: int = 0


class Engine:
    """Algorithm 1 over an I/O-determinized CEA."""

    def __init__(self, cea: CEA, window: WindowSpec = WindowSpec(),
                 consume_on_match: bool = False, max_enumerate: Optional[int] = None,
                 gc_every: int = 512):
        self.det = DetCEA(cea)
        self.registry = cea.registry
        self.window = window
        self.consume_on_match = consume_on_match
        self.max_enumerate = max_enumerate
        self.tecs = TECS()
        # T : det-state -> union-list, iterated in (first-)insertion order.
        # Python dicts preserve first-insertion order under value updates,
        # matching the paper's ordered-keys(T) exactly.
        self.T: Dict[int, UnionList] = {}
        self.j = -1
        self._timestamps: List[float] = []  # position -> timestamp
        self._gc_every = gc_every
        self.stats = EngineStats()

    # ------------------------------------------------------------------
    # window helpers
    # ------------------------------------------------------------------
    def _threshold_start(self, j: int) -> int:
        """Earliest admissible start *position* for outputs closing at ``j``."""
        w = self.window
        if w.kind == "none":
            return 0
        if w.kind == "events":
            return max(0, j - int(w.size))
        # time-based: binary search the earliest position whose timestamp is
        # within [ts(j) - size, ts(j)]  (stream order = time order).
        lo, hi = 0, j
        bound = self._timestamps[j] - w.size
        while lo < hi:
            mid = (lo + hi) // 2
            if self._timestamps[mid] < bound:
                lo = mid + 1
            else:
                hi = mid
        return lo

    # ------------------------------------------------------------------
    # Algorithm 1
    # ------------------------------------------------------------------
    def process(self, t: Event) -> List[ComplexEvent]:
        """Feed one event; return the complex events closing at this position."""
        self.j += 1
        j = self.j
        t.position = j
        if self.window.kind == "time":
            ts = float(t.get(self.window.time_attr)) if self.window.time_attr \
                else (t.timestamp if t.timestamp is not None else float(j))
            self._timestamps.append(ts)
        bitvec = self.registry.bitvector(t)

        Tp: Dict[int, UnionList] = {}

        def add(q: int, n: Node, ul: UnionList) -> None:
            if q in Tp:
                ulist_insert(self.tecs, Tp[q], n)
            else:
                Tp[q] = ul

        def exec_trans(p: int, ul: UnionList) -> None:
            n = ulist_merge(self.tecs, ul)
            q_mark, q_unmark = self.det.step(p, bitvec)
            if q_mark is not None:
                n2 = self.tecs.extend(n, j)
                add(q_mark, n2, new_ulist(n2))
            if q_unmark is not None:
                # Algorithm 1 line 28: pass the ORIGINAL list, not a fresh
                # singleton of the merged node — this keeps union-list heads
                # non-union, so merge() always returns safe (odepth ≤ 1)
                # nodes.  Safe to hand over: I/O-determinism gives each list
                # at most one ◦-successor, and T is discarded after the swap.
                add(q_unmark, n, ul)

        # lines 7–8: a new run may start at the current position
        exec_trans(self.det.initial, new_ulist(self.tecs.new_bottom(j)))
        # lines 9–10: iterate active states in first-insertion order, which
        # provably visits union-lists in decreasing max-start order.
        for p in self.T:
            exec_trans(p, self.T[p])
        self.T = Tp

        out = self._output(j)
        self.stats.events += 1
        self.stats.matches += len(out)
        self.stats.nodes = self.tecs.nodes_created
        self.stats.active_states = len(self.T)
        self.stats.det_states = self.det.num_det_states

        if out and self.consume_on_match:
            # experiments' consumption policy: forget all partial matches
            self.T = {}
        if self._gc_every and j % self._gc_every == self._gc_every - 1:
            self._evict(j)
        return out

    def _output(self, j: int) -> List[ComplexEvent]:
        results: List[ComplexEvent] = []
        threshold = self._threshold_start(j)
        cap = self.max_enumerate
        for p in self.T:
            if self.det.is_final(p):
                n = ulist_merge(self.tecs, self.T[p])
                for ce in enumerate_node(n, j, threshold):
                    results.append(ce)
                    if cap is not None and len(results) >= cap:
                        return results
        return results

    def _evict(self, j: int) -> None:
        """Window eviction (design deviation D3): drop union-list entries whose
        max-start can never satisfy the window again.  Replaces the paper's
        Java weak-reference scheme; amortized constant time."""
        if self.window.kind == "none":
            return
        threshold = self._threshold_start(j)
        dead: List[int] = []
        for q, ul in self.T.items():
            kept = [n for n in ul if n.max_start >= threshold]
            # max(n0) ≥ max(ni) for all i, so kept is empty or still headed by
            # the original non-union n0 — union-list invariants are preserved.
            if not kept:
                dead.append(q)
            elif len(kept) != len(ul):
                self.T[q] = kept
        for q in dead:
            del self.T[q]

    # ------------------------------------------------------------------
    def run(self, stream: Iterable[Event]) -> Iterator[Tuple[int, ComplexEvent]]:
        """Convenience: drive the engine over a stream, yielding (pos, match)."""
        for t in stream:
            for ce in self.process(t):
                yield self.j, ce
