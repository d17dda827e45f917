"""Dynamic query fleet: hot add/remove CEQL queries over a live stream.

CORE's target workload is *many concurrent user-defined patterns* whose rule
set evolves at runtime; :class:`~repro_torch.vector.multiquery.
MultiQueryEngine` freezes its query set at construction.
:class:`QueryFleet` serves a changing set:

* **Per-window buckets** — queries are routed by their *resolved*
  :class:`~repro_torch.kernels.window.DeviceWindow`; each bucket holds one
  packed engine (one window per pack), so mixed-window query sets serve
  side by side.
* **Size-bucketed packings** — every query-dependent device dimension is
  padded to a bucket size (packed states and query slots to powers of two;
  joint classes, predicate bits and encoder attributes to multiples of
  four).  Padding is *dead* by construction
  (:func:`~repro_torch.vector.multiquery.check_packing_invariants` runs on
  every repack): padded predicates are ``column 0 < -inf``, false for every
  value and for NaN.
* **A step cache keyed on bucket geometry** — a bucket's device step takes
  the packed tables as operands, so two packings of the same padded
  geometry share one cache entry; on CUDA every entry launches the same
  hand-written kernels of the one kernel library.  Arena buckets add the
  table fingerprint to the key: the entry holds the tECS arena's tables and
  layouts, which depend on the table values (not on qids), so a remove and
  a re-add under a fresh qid skips recomputing them.
* **Live state migration** — a repack snapshots the bucket's engine and
  restores it into the new packing through
  ``restore(migrate_packing=True)``: surviving queries keep their in-flight
  runs (bit-identical continuations), removed queries' state is dropped,
  new queries start empty at the current stream position.
* **Per-query cost reports** — states consumed, hits, match counts, live
  arena cells/nodes and overflow latches per query.

Cache counters, cost reports, manifests and snapshots are those of the
reference package's fleet, so a fleet checkpoint of either package restores
into the other.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.predicates import AtomRegistry
from ..core.query import compile_query
from ..kernels import fused_scan, ops
from ..kernels import window as wkern
from ..vector import tecs_arena
from ..vector.engine import resolve_device
from ..vector.multiquery import (MultiQueryEngine, Packing, build_packing,
                                 check_packing_invariants,
                                 resolve_query_window)
from ..vector.streaming import StreamingVectorEngine

#: the predicate op-code order of the bit-vector kernels: ==, !=, <, <=, >, >=
_OP_LT = 2

#: fleet snapshot layout version (the reference package's)
FLEET_SNAPSHOT_FORMAT = 1


def _pow2(n: int, lo: int = 1) -> int:
    p = max(1, int(lo))
    while p < n:
        p <<= 1
    return p


def _mult(n: int, m: int = 4, lo: int = 4) -> int:
    return max(lo, ((int(n) + m - 1) // m) * m)


class _CachedStep:
    """One cache entry: a device step bound to one bucket geometry.

    ``fn(operands, attrs, state, start, gbase, event_ts)`` runs one chunk;
    the first call records the entry's key in the cache's trace list (the
    moment the reference package's ``jax.jit`` traces).  ``state_bucket`` is
    the scan kernels' state instantiation the geometry runs on (8, 16, 32 or
    the wide build); ``arena_tables`` is set on arena entries only.
    """

    def __init__(self, cache: "CompileCache", key: tuple, fn: Callable,
                 arena_tables: Optional[tecs_arena.ArenaTables] = None):
        self.key = key
        self.state_bucket = fused_scan.state_bucket(key[0])
        self.arena_tables = arena_tables
        self._cache = cache
        self._fn = fn
        self._ran = False

    def __call__(self, *args):
        if not self._ran:
            self._ran = True
            self._cache._record_trace(self.key)
        return self._fn(*args)


class CompileCache:
    """Geometry-keyed cache of bucket device steps.

    One entry per distinct bucket geometry ``(padded_states,
    padded_query_slots, padded_classes, padded_bits, attr_slots, window,
    chunk_len, batch, arena, semantic operands)``.  Count-bucket entries take
    the packed tables as operands, so every packing of a geometry reuses
    one; arena entries also key on the packing's table fingerprint and
    ``arena_impl`` (the arena tables are value-dependent; qids are not, so
    renames still hit).  ``compile_count`` counts entries that have run,
    ``distinct_keys`` entries built.
    """

    def __init__(self):
        self._steps: Dict[tuple, _CachedStep] = {}
        #: keys in first-run order, one append per entry that ran
        self.traces: List[tuple] = []
        #: cache hits (an engine build that reused an existing entry)
        self.hits = 0

    @property
    def compile_count(self) -> int:
        return len(self.traces)

    @property
    def distinct_keys(self) -> int:
        return len(self._steps)

    def get(self, key: tuple, build: Callable[["CompileCache", tuple],
                                              _CachedStep]) -> _CachedStep:
        fn = self._steps.get(key)
        if fn is None:
            fn = self._steps[key] = build(self, key)
        else:
            self.hits += 1
        return fn

    def _record_trace(self, key: tuple) -> None:
        self.traces.append(key)


def _pad_attrs(attrs: torch.Tensor, slots: int) -> torch.Tensor:
    """Zero columns up to ``slots`` (padded predicates never read them)."""
    a = attrs.shape[-1]
    return (torch.nn.functional.pad(attrs, (0, slots - a)) if a < slots
            else attrs)


def _make_data_step(cache: CompileCache, key: tuple,
                    window: "wkern.DeviceWindow", impl: str) -> _CachedStep:
    """A counting step with the packed tables as operands: one
    ``cer_pipeline`` call over the engine's state buffers (the fused
    kernel on CUDA)."""
    attr_slots = key[4]

    def step(tables, attrs, state, start, gbase, event_ts=None):
        counts, _ = ops.cer_pipeline(
            _pad_attrs(attrs, attr_slots), tables["specs"],
            tables["class_of"], tables["class_ind"], tables["m_all"],
            tables["finals_q"], state, init_mask=tables["init_mask"],
            window=window, event_ts=event_ts, start_pos=start, impl=impl,
            latest_q=tables["latest_q"], consume_sq=tables["consume_sq"],
            inplace=True)
        return counts, None

    return _CachedStep(cache, key, step)


def _make_arena_step(cache: CompileCache, key: tuple,
                     atables: tecs_arena.ArenaTables,
                     window: "wkern.DeviceWindow", impl: str,
                     arena_impl: str) -> _CachedStep:
    """Counting + tECS-arena step: the entry keeps the arena tables (and
    the layouts cached on them), shared by every engine of its key."""
    attr_slots = key[4]

    def step(tables, attrs, state, start, gbase, event_ts=None):
        counts, _, _, roots = tecs_arena.scan_chunk(
            atables, state["arena"], _pad_attrs(attrs, attr_slots),
            state["C"], specs=tables["specs"], class_of=tables["class_of"],
            class_ind=tables["class_ind"], m_all=tables["m_all"],
            finals_q=tables["finals_q"], init_mask=tables["init_mask"],
            window=window, start=start, gbase=gbase, impl=impl,
            arena_impl=arena_impl, event_ts=event_ts,
            latest_q=tables["latest_q"], consume_sq=tables["consume_sq"],
            inplace=True)
        return counts, roots

    return _CachedStep(cache, key, step, arena_tables=atables)


class _FleetStreamEngine(StreamingVectorEngine):
    """Bucket-local streaming engine served from the fleet's
    :class:`CompileCache`.

    Its device step is the cached entry of its geometry: attributes are
    zero-padded on the device to ``attr_slots`` and the predicates padded to
    ``padded_bits`` with ``column 0 < -inf`` rows, so the kernel's class
    lookup reads the padded ``class_of`` of ``2^padded_bits`` rows.
    """

    def __init__(self, engine: MultiQueryEngine, chunk_len: int, batch: int,
                 *, cache: CompileCache, attr_slots: int,
                 impl: Optional[str] = None,
                 arena_capacity: Optional[int] = None,
                 arena_impl: Optional[str] = None,
                 strict_overflow: bool = False):
        self._cache = cache
        self._attr_slots = int(attr_slots)
        pk, w = engine.packing, engine.window
        self.geometry = (
            pk.padded_states, pk.padded_queries, pk.padded_classes,
            pk.padded_bits, self._attr_slots,
            w.kind, float(w.size), w.time_attr, int(w.ring),
            int(chunk_len), int(batch),
            None if arena_capacity is None else int(arena_capacity),
            # a LAST / CONSUME packing's step takes more operands, so it
            # must not share the ALL-only geometry's entry
            engine.tables.latest_q is not None,
            engine.tables.consume_sq is not None)
        self._entry: Optional[_CachedStep] = None
        super().__init__(engine, chunk_len, batch, impl=impl,
                         arena_capacity=arena_capacity,
                         arena_impl=arena_impl,
                         strict_overflow=strict_overflow)
        specs = list(self._specs)
        specs += [(0, _OP_LT, float("-inf"))] * (pk.padded_bits - len(specs))
        t = engine.tables
        # on the device once (the predicates are launch parameters):
        # feeds upload nothing but the chunk
        self._operands = {
            "specs": tuple(specs), "class_of": t.class_of,
            "class_ind": t.class_ind, "m_all": t.m_all,
            "finals_q": self._finals_q, "init_mask": t.init_mask,
            "latest_q": t.latest_q, "consume_sq": t.consume_sq}
        if self._entry is None:
            self._entry = cache.get(
                self.geometry,
                lambda c, k: _make_data_step(c, k, self.window, self.impl))

    def _build_arena_tables(self) -> tecs_arena.ArenaTables:
        pk = self.engine.packing
        self._entry = self._cache.get(
            self.geometry + ("arena", pk.table_fingerprint,
                             self.arena_impl),
            lambda c, k: _make_arena_step(
                c, k, self.engine.arena_tables(), self.window, self.impl,
                self.arena_impl))
        return self._entry.arena_tables

    def _device_step(self, attrs, event_ts):
        return self._entry(self._operands, attrs, self._state,
                           self._pos % self._ring, self._pos, event_ts)

    @property
    def compile_count(self) -> int:
        """Fleet-wide compile count — entries are shared, so a per-engine
        number would be meaningless."""
        return self._cache.compile_count


@dataclass
class _Bucket:
    key: tuple                       # (kind, size, time_attr)
    window: "wkern.DeviceWindow"
    qids: List[str] = field(default_factory=list)
    packing: Optional[Packing] = None
    engine: Optional[_FleetStreamEngine] = None


class QueryFleet:
    """A mutable set of compiled queries served over one live stream.

    ::

        fleet = QueryFleet(chunk_len=64, batch=4)
        qid = fleet.add_query("SELECT * FROM S WHERE A;B WITHIN 16 events")
        counts, hits = fleet.feed(streams)      # (T, B, n_live) int64
        fleet.remove_query(qid)

    ``add_query``/``remove_query`` repack only the affected window bucket —
    host work (query compilation and a state migration); the device step is
    almost always a :class:`CompileCache` hit.  ``feed`` drives every
    bucket in lockstep over the same chunk and returns de-packed per-query
    counts, columns ordered by sorted qid (:attr:`live_qids`).

    Construction parameters mirror the streaming engines; ``epsilon`` is
    the *default* count window for queries without a WITHIN clause, and
    ``max_window_events`` the default rate bound for time windows.
    ``device=None`` runs on CUDA (``RuntimeError`` without one); pass
    ``device="cpu"`` for the plain PyTorch version.  ``impl`` routes every
    bucket's pipeline (``"fused"``, ``"unfused"`` or ``"ref"``).
    """

    def __init__(self, chunk_len: int, batch: int, *,
                 epsilon: Optional[int] = None,
                 arena_capacity: Optional[int] = None,
                 arena_impl: str = "block",
                 max_window_events: Optional[int] = None,
                 strict_overflow: bool = False,
                 min_state_slots: int = 8, min_query_slots: int = 1,
                 check_invariants: bool = True,
                 impl: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.impl = "fused" if impl is None else impl
        if self.impl not in ops.IMPLS:
            raise ValueError(f"impl must be one of {ops.IMPLS}, got "
                             f"{self.impl!r}")
        self.chunk_len = int(chunk_len)
        self.batch = int(batch)
        self.epsilon = epsilon
        self.arena_capacity = arena_capacity
        self.arena_impl = arena_impl
        self.max_window_events = max_window_events
        self.strict_overflow = bool(strict_overflow)
        self.min_state_slots = int(min_state_slots)
        self.min_query_slots = int(min_query_slots)
        self.check_invariants = bool(check_invariants)
        self._cache = CompileCache()
        self._queries: Dict[str, str] = {}
        self._buckets: Dict[tuple, _Bucket] = {}
        self._stats: Dict[str, Dict[str, int]] = {}
        self._pos = 0
        self._next_id = 0

    # -- introspection --------------------------------------------------
    @property
    def position(self) -> int:
        """Absolute stream position of the next event to arrive."""
        return self._pos

    @property
    def live_qids(self) -> List[str]:
        """Live query ids in feed-column order (sorted)."""
        return sorted(self._queries)

    @property
    def num_queries(self) -> int:
        return len(self._queries)

    @property
    def num_buckets(self) -> int:
        return len(self._buckets)

    @property
    def compile_count(self) -> int:
        """Cache entries that have run since construction."""
        return self._cache.compile_count

    @property
    def distinct_geometries(self) -> int:
        """Distinct cache keys ever built (the compile ceiling)."""
        return self._cache.distinct_keys

    @property
    def cache_hits(self) -> int:
        return self._cache.hits

    def query_text(self, qid: str) -> str:
        return self._queries[qid]

    def bucket_of(self, qid: str) -> tuple:
        """The (kind, size, time_attr) window key serving ``qid``."""
        return self._find_bucket(qid).key

    # -- membership -----------------------------------------------------
    def _window_of(self, text: str) -> "wkern.DeviceWindow":
        # throwaway compile against a scratch registry: only the parsed
        # WITHIN clause is needed for routing; the bucket's shared-registry
        # compile happens in build_packing
        cq = compile_query(text, AtomRegistry())
        return resolve_query_window(
            cq.query.window, epsilon=self.epsilon,
            max_window_events=self.max_window_events)

    def _find_bucket(self, qid: str) -> _Bucket:
        for b in self._buckets.values():
            if qid in b.qids:
                return b
        raise KeyError(f"no live query {qid!r} in this fleet")

    def add_query(self, text: str, qid: Optional[str] = None) -> str:
        """Compile and start serving ``text``; returns its qid.

        The query joins the bucket of its resolved window at the current
        stream position (it observes events from now on: its counts equal
        a fresh engine's fed only the suffix after the add).  Only that
        bucket repacks; its surviving queries' live runs migrate
        bit-identically.
        """
        if qid is None:
            qid = f"q{self._next_id}"
            self._next_id += 1
        if qid in self._queries:
            raise ValueError(f"query id {qid!r} is already live")
        window = self._window_of(text)
        key = (window.kind, float(window.size), window.time_attr)
        self._queries[qid] = text
        bucket = self._buckets.get(key)
        if bucket is None:
            bucket = self._buckets[key] = _Bucket(key=key, window=window)
        bucket.qids = sorted(bucket.qids + [qid])
        self._stats[qid] = {"hits": 0, "matches": 0, "events": 0}
        try:
            self._repack(bucket)
        except Exception:
            # leave the fleet as it was: a bad query must not take down
            # the bucket's healthy residents
            del self._queries[qid]
            del self._stats[qid]
            bucket.qids.remove(qid)
            if not bucket.qids:
                del self._buckets[key]
            else:
                self._repack(bucket)
            raise
        return qid

    def remove_query(self, qid: str) -> None:
        """Stop serving ``qid``; its state is dropped, the bucket repacks.

        Removing the last query of a bucket drops the bucket (and its
        device state) entirely.
        """
        bucket = self._find_bucket(qid)
        del self._queries[qid]
        del self._stats[qid]
        bucket.qids.remove(qid)
        if not bucket.qids:
            del self._buckets[bucket.key]
            return
        self._repack(bucket)

    # -- repack ---------------------------------------------------------
    def _build_packing(self, qids: Sequence[str]) -> Packing:
        return build_packing(
            [self._queries[q] for q in qids], qids=tuple(qids),
            pad_states=lambda n: _pow2(n, self.min_state_slots),
            pad_queries=lambda n: _pow2(n, self.min_query_slots),
            pad_classes=_mult, pad_bits=_mult)

    def _build_engine(self, bucket: _Bucket,
                      packing: Packing) -> _FleetStreamEngine:
        engine = MultiQueryEngine.from_packing(
            packing, epsilon=self.epsilon, impl=self.impl,
            arena_impl=self.arena_impl,
            max_window_events=self.max_window_events, device=self.device)
        if (engine.window.kind, float(engine.window.size),
                engine.window.time_attr) != bucket.key:
            raise ValueError(
                f"packing resolved window {engine.window} but was routed "
                f"to bucket {bucket.key} — query text changed meaning?")
        attr_slots = _mult(len(packing.encoder.attrs))
        return _FleetStreamEngine(
            engine, self.chunk_len, self.batch, cache=self._cache,
            attr_slots=attr_slots, impl=self.impl,
            arena_capacity=self.arena_capacity, arena_impl=self.arena_impl,
            strict_overflow=self.strict_overflow)

    def _repack(self, bucket: _Bucket) -> None:
        packing = self._build_packing(bucket.qids)
        if self.check_invariants:
            check_packing_invariants(packing)
        se = self._build_engine(bucket, packing)
        old = bucket.engine
        if old is not None:
            # live migration: surviving queries keep their in-flight runs
            se.restore(old.snapshot(), migrate_packing=True)
        else:
            se._pos = self._pos     # new bucket joins mid-stream
        bucket.packing = packing
        bucket.engine = se

    # -- feeding --------------------------------------------------------
    def _sorted_buckets(self) -> List[_Bucket]:
        return [self._buckets[k] for k in
                sorted(self._buckets, key=lambda k: (k[0], k[1], k[2] or ""))]

    def feed(self, streams) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
        """Feed one chunk of B streams × chunk_len events to every bucket.

        Returns ``(counts, hits)``: counts is ``(chunk_len, B, n_live)``
        int64 with columns in :attr:`live_qids` order; hits is the sorted
        list of absolute ``(position, stream)`` pairs where *any* live
        query matched.
        """
        per_q: Dict[str, np.ndarray] = {}
        hit_set: set = set()
        for bucket in self._sorted_buckets():
            counts, hits = bucket.engine.feed(streams)
            hit_set.update(hits)
            for slot, qid in enumerate(bucket.qids):
                cq = counts[:, :, slot]
                per_q[qid] = cq
                st = self._stats[qid]
                st["matches"] += int(cq.sum())
                st["hits"] += int((cq > 0).sum())
                st["events"] += cq.size
        self._pos += self.chunk_len
        qids = self.live_qids
        if qids:
            out = np.stack([per_q[q] for q in qids], axis=-1)
        else:
            out = np.zeros((self.chunk_len, self.batch, 0), np.int64)
        return out, sorted(hit_set)

    def counts_by_query(self, counts: np.ndarray) -> Dict[str, np.ndarray]:
        """De-pack a :meth:`feed` counts array into ``{qid: (T, B)}``."""
        return {q: counts[:, :, i] for i, q in enumerate(self.live_qids)}

    # -- enumeration (requires arena_capacity) --------------------------
    def enumerate(self, qid: str, position: int, stream: int = 0,
                  strategy: Optional[str] = None):
        """Complex events of ``qid`` closing at ``position`` on ``stream``
        — walks the bucket's device tECS arena.

        ``strategy=None`` (default) enumerates under the query's compiled
        selection semantics; an explicit strategy is the host post-filter,
        valid only when the bucket carries no native semantics
        (:func:`repro_torch.vector.tecs_arena.resolve_enum_strategy`).
        """
        bucket = self._find_bucket(qid)
        slot = bucket.qids.index(qid)
        return bucket.engine.enumerate(position, stream, query=slot,
                                       strategy=strategy)

    def clear_roots(self, before: Optional[int] = None) -> int:
        """Prune recorded enumeration roots across every bucket engine.

        ``before`` drops only roots at positions ``< before`` (the service
        layer's emission high-water mark); None drops all.  Returns the
        total number of entries dropped.
        """
        return sum(bucket.engine.clear_roots(before)
                   for bucket in self._buckets.values()
                   if bucket.engine is not None)

    # -- cost reporting -------------------------------------------------
    def cost_report(self) -> Dict[str, Dict[str, Any]]:
        """Per-query serving cost.

        ``states``: packed states consumed; ``hits``/``matches``: lifetime
        totals while live; ``arena_cells``/``arena_nodes``: live tECS cells
        in the query's state region and the distinct nodes they reference
        (0 with the arena off); ``overflow_lanes``: lanes whose rate-bound
        latch tripped in the query's bucket; plus the bucket key, slot, and
        bucket geometry — the inputs a rebalancer needs.
        """
        report: Dict[str, Dict[str, Any]] = {}
        for bucket in self._sorted_buckets():
            eng, pk = bucket.engine, bucket.packing
            ovf = [int(b) for b in np.nonzero(eng.window_overflow)[0]]
            cell = (eng.state["arena"]["cell"].cpu().numpy()
                    if self.arena_capacity is not None else None)
            for slot, qid in enumerate(bucket.qids):
                off, sz = pk.offsets[slot], pk.sizes[slot]
                d: Dict[str, Any] = {
                    "states": int(sz),
                    "bucket": bucket.key,
                    "slot": int(slot),
                    "geometry": eng.geometry,
                    "hits": int(self._stats[qid]["hits"]),
                    "matches": int(self._stats[qid]["matches"]),
                    "events": int(self._stats[qid]["events"]),
                    "overflow_lanes": ovf,
                    "arena_cells": 0,
                    "arena_nodes": 0,
                }
                if cell is not None:
                    region = cell[:, :, off:off + sz]
                    live = region[region != tecs_arena.NULL]
                    d["arena_cells"] = int(live.size)
                    d["arena_nodes"] = int(np.unique(live).size)
                report[qid] = d
        return report

    # -- crash-safe snapshots -------------------------------------------
    def manifest(self) -> dict:
        """Fleet-level restore manifest: geometry, per-query membership,
        and per-bucket packing fingerprints (all JSON-able)."""
        buckets = []
        for bucket in self._sorted_buckets():
            buckets.append({
                "key": list(bucket.key),
                "qids": list(bucket.qids),
                "fingerprint": bucket.packing.fingerprint,
                "manifest": bucket.engine.manifest(),
            })
        return {
            "format": FLEET_SNAPSHOT_FORMAT,
            "engine": type(self).__name__,
            "chunk_len": self.chunk_len,
            "batch": self.batch,
            "epsilon": (None if self.epsilon is None else int(self.epsilon)),
            "arena_capacity": (None if self.arena_capacity is None
                               else int(self.arena_capacity)),
            "pos": int(self._pos),
            "next_id": int(self._next_id),
            "queries": dict(self._queries),
            "stats": {q: dict(s) for q, s in self._stats.items()},
            "buckets": buckets,
        }

    def snapshot(self) -> dict:
        """``{"arrays", "meta"}`` across every bucket — feed to
        ``CheckpointManager.save`` / :class:`~repro_torch.runtime.recovery.
        RecoveringStreamRunner`."""
        arrays: Dict[str, np.ndarray] = {}
        for i, bucket in enumerate(self._sorted_buckets()):
            sub = bucket.engine.snapshot()
            for name, arr in sub["arrays"].items():
                arrays[f"bucket{i}/{name}"] = arr
        return {"arrays": arrays, "meta": self.manifest()}

    def restore(self, snapshot: dict) -> None:
        """Rebuild membership and buckets from the manifest and restore
        every bucket's engine state.

        The fleet must have been constructed with the same ``chunk_len`` /
        ``batch`` / ``epsilon`` / ``arena_capacity``.  Each bucket's packing
        is rebuilt from the recorded qids and query texts and verified
        against the recorded fingerprint — a mismatch (changed query
        semantics, different code version) refuses to restore rather than
        silently reinterpreting state.
        """
        meta, arrays = snapshot["meta"], snapshot["arrays"]
        if meta.get("engine") != type(self).__name__ or \
                meta.get("format") != FLEET_SNAPSHOT_FORMAT:
            raise ValueError(
                f"snapshot is a {meta.get('engine')!r} format "
                f"{meta.get('format')!r}, not a QueryFleet snapshot")
        for k in ("chunk_len", "batch", "epsilon", "arena_capacity"):
            mine = getattr(self, k)
            mine = None if mine is None else int(mine)
            if meta.get(k) != mine:
                raise ValueError(
                    f"snapshot {k}={meta.get(k)!r} != fleet {mine!r} — "
                    "construct the fleet with matching geometry")
        self._queries = dict(meta["queries"])
        self._stats = {q: {kk: int(vv) for kk, vv in s.items()}
                       for q, s in meta.get("stats", {}).items()}
        self._pos = int(meta["pos"])
        self._next_id = int(meta.get("next_id", 0))
        self._buckets = {}
        for i, bm in enumerate(meta["buckets"]):
            key = (bm["key"][0], float(bm["key"][1]), bm["key"][2])
            qids = list(bm["qids"])
            window = self._window_of(self._queries[qids[0]])
            bucket = _Bucket(key=key, window=window, qids=qids)
            packing = self._build_packing(qids)
            if packing.fingerprint != bm["fingerprint"]:
                raise ValueError(
                    f"bucket {key} repacked to fingerprint "
                    f"{packing.fingerprint[:12]}… but the snapshot recorded "
                    f"{bm['fingerprint'][:12]}… — the query set compiles "
                    "differently now; its state cannot be trusted")
            se = self._build_engine(bucket, packing)
            prefix = f"bucket{i}/"
            sub = {name[len(prefix):]: arr for name, arr in arrays.items()
                   if name.startswith(prefix)}
            se.restore({"arrays": sub, "meta": bm["manifest"]})
            bucket.packing = packing
            bucket.engine = se
            self._buckets[key] = bucket

    # -- maintenance ----------------------------------------------------
    def reset(self) -> None:
        """Drop all live runs (and arena nodes) in every bucket; rewind."""
        self._pos = 0
        for bucket in self._buckets.values():
            bucket.engine.reset()
        for st in self._stats.values():
            st.update(hits=0, matches=0, events=0)
