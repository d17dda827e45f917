"""PARTITION BY on the device: one interleaved stream, one lane per key.

CORE's PARTITION BY splits the stream into maximal substreams that agree
(and are non-NULL) on the key attributes, and runs WHERE-SELECT-WITHIN on
each substream separately.  The host implementation
(:class:`repro_torch.core.partition.PartitionedEngine`) keeps a dict of
engines.  :class:`PartitionedStreamingEngine` takes raw interleaved chunks
and, per chunk on the device:

1. **Lane assignment** — :func:`repro_torch.kernels.ops.lane_route` (the
   Hopper lane-routing kernel on CUDA): events of a resident key go to its
   lane; a new key claims the lowest empty lane or, with ``evict="lru"``,
   evicts the least recently used lane that has no event yet this chunk;
   NULL keys are dropped; new keys that find no lane spill.  Evicted lanes
   restart from scratch: their ring, position and arena cells are reset.
2. **Dense scatter** — lane ``b`` receives its first ``n_b ≤ lane_cap``
   events of the chunk in stream order (the router's ranks place them);
   later ones spill.
3. **Fused scan** — :func:`repro_torch.kernels.ops.cer_pipeline` with
   per-lane ``start_pos`` (substream-local positions, so count windows
   count substream events, as the host engine does) and ``valid_counts``.
4. **Relabelling** — counts gather back to the chunk's event order, so
   position ``base + t`` of the global stream gets the count of complex
   events closing at event ``t``.  With ``arena_capacity`` set each lane
   keeps its tECS arena (nodes labelled with global positions) and
   :meth:`PartitionedStreamingEngine.enumerate` walks it without replay.

Under a ``torch.profiler`` session each
:meth:`PartitionedStreamingEngine.feed_keyed` records four spans
(:func:`repro_torch.trace.span`), in this order, three of them under the
names :meth:`StreamingVectorEngine.feed_attrs` gives the same layers:
``streaming.device_step``, the host's time to hand the chunk to the device
(route, reset, scatter, scan launch, relabel and the stats stack, enqueued;
the kernels run on after it returns); ``partitioned.stats_to_host``, the
routing stats' copy and the :class:`PartitionStats` update: the copy first
waits for the step, so this span is the host's wait for the device, which
``feed_attrs`` folds into its counts copy; ``streaming.counts_to_host``,
the counts' copy; ``streaming.hit_list``, the counts as int64, the sum over
the queries, ``np.nonzero`` and the list of global hit positions.  With no
profiler recording, nothing is recorded.

The key hash is the process-stable 32-bit hash of
:func:`repro_torch.core.partition.stable_key_hash`; :meth:`feed` checks that
no two keys it has seen share a hash.  Snapshots use the reference
package's layout (``state/lane_keys`` uint32), so either package restores
the other's.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.events import ComplexEvent, Event
from ..core.partition import EMPTY_LANE, NULL_KEY_HASH, partition_key
from ..core.selection import apply_strategy
from ..kernels import ops
from ..kernels import ref as kref
from ..kernels import window as wkern
from ..trace import span
from . import tecs_arena
from .streaming import StreamingVectorEngine, _flatten_state, _restore_into

_I32_MAX = np.iinfo(np.int32).max
#: EMPTY_LANE as the int32 bit pattern the device tables hold
_EMPTY_BITS = int(np.uint32(EMPTY_LANE).view(np.int32))

_JSON_KEY_TYPES = (str, int, float, bool)


def _encode_hash_to_key(hash_to_key: Dict[int, tuple]):
    """JSON-able form of the collision-audit table, or None when a key
    holds values JSON cannot round-trip (the audit then restarts empty
    after a restore)."""
    out = []
    for h, key in hash_to_key.items():
        if not all(v is None or isinstance(v, _JSON_KEY_TYPES) for v in key):
            return None
        out.append([int(h), list(key)])
    return out


def _slots(route: kref.LaneRoute, lanes: int, cap: int):
    """(routed, kept, slot) per event: a routed event is kept among its
    lane's first ``cap``; a kept event's slot is ``lane·cap + rank``, any
    other's the dropped tail ``lanes·cap``."""
    routed = route.lane < lanes
    keep = routed & (route.rank < cap)
    slot = torch.where(keep, route.lane.long() * cap + route.rank.long(),
                       lanes * cap)
    return routed, keep, slot


def _lanes_of(rows: torch.Tensor, slot: torch.Tensor, lanes: int, cap: int,
              fill) -> torch.Tensor:
    """Scatter ``(T, ...)`` rows to their ``slot`` (``lane·cap + rank``, or
    the dropped tail ``lanes·cap``) → ``(cap, lanes, ...)``, ``fill``
    elsewhere."""
    tail = tuple(rows.shape[1:])
    buf = torch.full((lanes * cap + 1,) + tail, fill, dtype=rows.dtype,
                     device=rows.device)
    buf[slot] = rows
    return buf[:lanes * cap].reshape((lanes, cap) + tail).movedim(
        0, 1).contiguous()


@dataclass
class PartitionStats:
    """Cumulative routing outcomes across feeds (host bookkeeping)."""

    events: int = 0
    routed: int = 0
    dropped_null: int = 0        # NULL partition key: joins no substream
    spilled_table: int = 0       # new key, no free or evictable lane
    spilled_capacity: int = 0    # lane already had lane_cap events
    evicted_lanes: int = 0       # lanes reassigned to a new key
    overflow_lanes: int = 0      # lanes whose time-window latch is set now
    quarantined_lanes: int = 0   # lanes parked mid-overflow-heal now


class PartitionedStreamingEngine(StreamingVectorEngine):
    """PARTITION BY over the device pipeline.

    :meth:`feed` takes ONE interleaved chunk of ``chunk_len`` raw events and
    routes it to ``num_lanes`` partition lanes on the device.  Counts and
    hits come back in global stream positions and equal
    :class:`repro_torch.core.partition.PartitionedEngine`'s as long as
    nothing spilled or was evicted (both are counted in ``stats``).
    """

    def __init__(self, engine, key_attrs: Sequence[str], chunk_len: int,
                 num_lanes: int, lane_cap: Optional[int] = None,
                 impl: Optional[str] = None, evict: str = "lru",
                 arena_capacity: Optional[int] = None,
                 arena_impl: Optional[str] = None,
                 strict_overflow: bool = False):
        """``engine``: a constructed VectorEngine or MultiQueryEngine.

        key_attrs: PARTITION BY attributes (need not appear in predicates).
        num_lanes: partitions resident on the device at once (L).
        lane_cap:  events a lane takes per chunk (default ``chunk_len``: no
                   capacity spill); fewer means less padded scan work.
        evict:     "lru" (a new key may evict the least recently used lane
                   with no event yet this chunk) or "none" (it spills).
        arena_capacity: when set, each lane keeps its tECS arena, nodes
                   labelled with global stream positions, and hits become
                   enumerable through :meth:`enumerate`.
        """
        if evict not in kref.EVICT_POLICIES:
            raise ValueError(f"evict must be 'lru' or 'none', got {evict!r}")
        # before super().__init__, which builds the state through
        # _init_full_state
        self.num_lanes = int(num_lanes)
        super().__init__(engine, chunk_len, batch=num_lanes, impl=impl,
                         arena_capacity=arena_capacity,
                         arena_impl=arena_impl,
                         strict_overflow=strict_overflow)
        self.key_attrs = tuple(key_attrs)
        self.lane_cap = int(lane_cap) if lane_cap is not None else chunk_len
        self.evict = evict
        self.stats = PartitionStats()
        self._hash_to_key: Dict[int, tuple] = {}
        # substream-local arrival-order clock (time windows with no
        # time_attr and no event timestamps): an event of partition h gets
        # its rank in the substream as its timestamp, the host engine's
        # per-partition position clock
        self._fallback_clock: Dict[int, int] = {}
        self._chunk_idx = 0

    # ------------------------------------------------------------------
    def _init_full_state(self, batch: int):
        return self._init_lane_state(batch)

    def _init_lane_state(self, lanes: int, device=None):
        dev = self.device if device is None else device
        st = {
            "C": wkern.init_state(self.window, lanes,
                                  int(self._m_all.shape[1]), device=dev),
            # uint32 as the reference writes it, made as int32 bits
            "lane_keys": torch.full((lanes,), _EMPTY_BITS, dtype=torch.int32,
                                    device=dev).view(torch.uint32),
            "lane_pos": torch.zeros((lanes,), dtype=torch.int32, device=dev),
            "lane_last": torch.full((lanes,), -1, dtype=torch.int32,
                                    device=dev),
        }
        if self.arena_capacity is not None:
            st["arena"] = tecs_arena.init_arena(
                lanes, self.arena_capacity, self._ring,
                self._arena_tables.num_states, device=dev)
        return st

    def _lane_keys_np(self) -> np.ndarray:
        return self._state["lane_keys"].view(torch.int32).cpu().numpy().view(
            np.uint32)

    def _reset_lanes(self, lanes: torch.Tensor) -> None:
        """Restart the partitions of the ``lanes`` (L,) bool mask from
        scratch: empty ring, position 0, NULL arena cells.  Nodes already
        built stay: ids are never recycled.  In place."""
        st = self._state
        C = st["C"]
        if self.window.is_time:
            C["C"].masked_fill_(lanes[:, None, None], 0.0)
            C["ts"].masked_fill_(lanes[:, None], wkern.TS_EMPTY)
            C["ovf"].masked_fill_(lanes, False)
        else:
            C.masked_fill_(lanes[:, None, None], 0.0)
        st["lane_pos"].masked_fill_(lanes, 0)
        if self.arena_capacity is not None:
            st["arena"]["cell"].masked_fill_(lanes[:, None, None],
                                             tecs_arena.NULL)

    # ------------------------------------------------------------------
    def _step(self, attrs: torch.Tensor, keys: torch.Tensor,
              gpos: Optional[torch.Tensor], event_ts):
        """One chunk on the device: route, reset evicted lanes, scatter,
        scan, relabel, and the arena.  Returns ``(counts (T, Q) f32, lanes
        (T,) int32 — L where not scanned —, roots (T, Qa) | None, stats
        (6,) int64)``."""
        st = self._state
        L, cap = self.num_lanes, self.lane_cap
        timed = self.window.is_time
        with_arena = self.arena_capacity is not None

        # --- 1. lane assignment, and evicted lanes restart ---------------
        route = ops.lane_route(keys, st["lane_keys"], st["lane_last"],
                               chunk_idx=self._chunk_idx, cap=cap,
                               evict=self.evict, impl=self.impl)
        self._reset_lanes(route.evicted)
        lane_pos = st["lane_pos"]

        # --- 2. dense scatter: each lane's events in stream order --------
        routed, keep, slot = _slots(route, L, cap)
        attrs_lanes = _lanes_of(attrs, slot, L, cap, 0.0)    # (cap, L, A)
        ts_lanes = (_lanes_of(event_ts, slot, L, cap, 0.0)   # (cap, L)
                    if timed else None)

        # --- 3. fused scan at per-lane substream positions ---------------
        ts_ring0 = st["C"]["ts"].clone() if timed and with_arena else None
        pipe = ops.cer_pipeline(
            attrs_lanes, self._specs, self._class_of, self._class_ind,
            self._m_all, self._finals_q, st["C"], init_mask=self._init_mask,
            window=self.window, event_ts=ts_lanes, start_pos=lane_pos,
            valid_counts=route.fill, impl=self.impl,
            return_trace=with_arena, latest_q=self._latest_q,
            consume_sq=self._consume_sq, inplace=True)
        matches = pipe[0]                                     # (cap, L, Q)

        # --- 4. relabel: routed-slot counts → chunk event order ----------
        NQ = matches.shape[-1]
        counts = torch.cat([matches.movedim(0, 1).reshape(L * cap, NQ),
                            matches.new_zeros((1, NQ))])[slot]

        # --- 5. tECS arena: per-lane node stores, global labels ----------
        roots = None
        if with_arena:
            gpos_lanes = _lanes_of(gpos, slot, L, cap, -1)    # (cap, L)
            expire = (tecs_arena.window_expire_masks(
                self.window, ts_ring0, ts_lanes, lane_pos, route.fill)
                if timed else None)
            # the arena runs on live dims (cf. scan_chunk)
            Qa = self._arena_tables.num_queries
            hitsq = (matches > 0.5)[..., :Qa]
            consume = None
            if self._consume_sq is not None:
                csq = self._consume_sq.to(torch.float32)[
                    :Qa, :self._arena_tables.num_states]
                consume = torch.einsum("tbq,qs->tbs", hitsq.to(torch.float32),
                                       csq) > 0.5
            _, lane_roots = tecs_arena.run_arena_scan(
                self._arena_tables, st["arena"], pipe[2], gpos_lanes,
                lane_pos, route.fill, hitsq, epsilon=self.epsilon,
                expire=expire, consume=consume, arena_impl=self.arena_impl,
                impl=self.impl)
            roots = torch.cat([
                lane_roots.movedim(0, 1).reshape(L * cap, Qa),
                lane_roots.new_full((1, Qa), tecs_arena.NULL)])[slot]

        # positions are consumed mod W only (ring slots), so the per-lane
        # cursor wraps mod W: exact, and int32 never overflows
        lane_pos.copy_((lane_pos + route.fill) % self._ring)
        st["lane_keys"].view(torch.int32).copy_(route.lane_keys)
        st["lane_last"].copy_(route.lane_last)
        ovf = (st["C"]["ovf"].sum() if timed
               else torch.zeros((), dtype=torch.int64, device=keep.device))
        stats = torch.stack([route.null.sum(), (routed & ~keep).sum(),
                             route.fill.sum(), routed.sum(),
                             route.evicted.sum(), ovf]).to(torch.int64)
        return counts, torch.where(keep, route.lane, L), roots, stats

    # ------------------------------------------------------------------
    def feed(self, events: Sequence[Event]) -> Tuple[np.ndarray, List[int]]:
        """Feed one chunk of ``chunk_len`` raw interleaved events.

        Returns ``(counts, hits)``: counts ``(chunk_len,)`` int64 match
        counts per *global* stream position (a trailing query axis for a
        multi-query engine); hits the sorted global positions with ≥ 1
        match.
        """
        if len(events) != self.chunk_len:
            raise ValueError(
                f"partitioned chunk must have chunk_len={self.chunk_len} "
                f"events; got {len(events)}.  Pad the tail chunk on the "
                "host.")
        audit_ts = True
        if self.window.is_time:
            attrs, keys, ts = self.encoder.encode_stream_keyed_ts(
                events, self.key_attrs, self.window.time_attr,
                clock=(self._fallback_clock
                       if self.window.time_attr is None else None))
            if self.window.time_attr is None and any(
                    ev.timestamp is None for ev in events
                    if partition_key(ev, self.key_attrs) is not None):
                # synthesized substream-local clocks are monotone per lane
                # but not across the interleaved stream: no global audit
                audit_ts = False
        else:
            attrs, keys = self.encoder.encode_stream_with_keys(
                events, self.key_attrs)
            ts = None
        for ev, h in zip(events, keys):       # audit reuses encoder hashes
            key = partition_key(ev, self.key_attrs)
            if key is None:
                continue
            prev = self._hash_to_key.setdefault(int(h), key)
            if prev != key:
                raise ValueError(
                    f"partition hash collision: {prev!r} and {key!r} both "
                    f"hash to {int(h):#x}; routing would merge their "
                    "substreams")
        return self.feed_keyed(
            torch.from_numpy(attrs).to(self.device), keys,
            event_ts=None if ts is None
            else torch.from_numpy(ts).to(self.device), audit_ts=audit_ts)

    def feed_keyed(self, attrs, keys, positions: Optional[np.ndarray] = None,
                   event_ts=None, audit_ts: bool = True
                   ) -> Tuple[np.ndarray, List[int]]:
        """Device-tensor entry point: attrs ``(chunk_len, A)`` f32 and
        ``(chunk_len,)`` 32-bit key hashes (uint32, or their int32 bits).

        Skips the collision audit: callers hashing their own keys own that
        risk.  ``positions`` ``(chunk_len,)`` gives each row's global
        stream position (the sharded path feeds a non-contiguous slice of
        the stream); hits are labelled from it.  Time windows take
        ``event_ts`` ``(chunk_len,)`` f32; the routed rows must be monotone
        in time across feeds (audited unless ``positions`` is given or
        ``audit_ts`` is False).
        """
        attrs = torch.as_tensor(attrs, dtype=torch.float32,
                                device=self.device)
        keys = kref.key_bits(keys)
        T = attrs.shape[0]
        if T != self.chunk_len or attrs.ndim != 2 or \
                tuple(keys.shape) != (T,):
            raise ValueError(f"expected attrs (chunk_len={self.chunk_len}, "
                             f"A) and keys ({self.chunk_len},); got "
                             f"{tuple(attrs.shape)} / {tuple(keys.shape)}")
        keys = keys.to(self.device)
        if self.window.is_time:
            if event_ts is None:
                raise ValueError("time-window partitioned feeds need the "
                                 "event_ts (chunk_len,) operand")
            event_ts = torch.as_tensor(event_ts, dtype=torch.float32,
                                       device=self.device)
            if positions is None and audit_ts:
                # NULL-key rows join no substream: their placeholder
                # timestamps never reach a lane
                keys_np = keys.cpu().numpy().view(np.uint32)
                routed_rows = (keys_np != np.uint32(NULL_KEY_HASH)) & \
                    (keys_np != np.uint32(EMPTY_LANE))
                if routed_rows.any():
                    self._last_ts = wkern.audit_monotone_ts(
                        event_ts.cpu().numpy()[routed_rows], self._last_ts)
        elif event_ts is not None:
            raise ValueError("event_ts was passed but the query window is "
                             "count-based")
        base = self._pos
        if positions is None:
            pos_arr = base + np.arange(T, dtype=np.int64)
        else:
            pos_arr = np.asarray(positions, dtype=np.int64)
        gpos = None
        if self.arena_capacity is not None:
            if int(pos_arr.max(initial=0)) > _I32_MAX:
                raise ValueError(
                    f"arena node labels are int32 stream positions; "
                    f"position {int(pos_arr.max())} exceeds {_I32_MAX}.  "
                    "reset() the engine")
            gpos = (torch.arange(base, base + T, dtype=torch.int32,
                                 device=self.device) if positions is None
                    else torch.from_numpy(pos_arr.astype(np.int32)).to(
                        self.device))
        with span("streaming.device_step"):
            counts_f, lanes, roots, stats_t = self._step(attrs, keys, gpos,
                                                         event_ts)
        self._pos += T
        self._chunk_idx += 1

        with span("partitioned.stats_to_host"):
            null, spill_cap, kept, routed, evicted, ovf = (
                int(x) for x in stats_t.cpu().numpy())
            st = self.stats
            st.events += T
            st.dropped_null += null
            st.spilled_capacity += spill_cap
            st.routed += kept
            st.spilled_table += T - routed - null
            st.evicted_lanes += evicted
            st.overflow_lanes = ovf                     # latch state
            st.quarantined_lanes = len(self._quarantined)

        with span("streaming.counts_to_host"):
            counts_h = counts_f.cpu()
        with span("streaming.hit_list"):
            counts = counts_h.numpy().astype(np.int64)          # (T, Q)
            hit_rows = np.nonzero(counts.sum(axis=-1))[0]
            if self._single_query:
                counts = counts[:, 0]
            if positions is None:
                hits = (base + hit_rows).tolist()
            else:
                hits = sorted(pos_arr[hit_rows].tolist())
        if roots is not None:
            roots_np = roots.cpu().numpy()
            lanes_np = lanes.cpu().numpy()
            for t in hit_rows:
                self._roots[int(pos_arr[t])] = (int(lanes_np[t]),
                                                roots_np[t])
        self._check_overflow()
        return counts, hits

    # ------------------------------------------------------------------
    # tECS-arena enumeration at global positions
    # ------------------------------------------------------------------
    def enumerate(self, position: int, *, query: int = 0,
                  strategy: Optional[str] = None, snapshot=None
                  ) -> List[ComplexEvent]:
        """Complex events closing at global ``position``: start, end and
        data are global stream positions, as the host
        ``PartitionedEngine`` labels them.  ``strategy=None`` enumerates
        under the query's compiled semantics.  There is one interleaved
        stream, so no ``stream`` argument; the rest is keyword-only."""
        if not isinstance(position, (int, np.integer)):
            raise TypeError(
                f"position must be a global stream position (int), got "
                f"{position!r} — the partitioned engine has no stream axis")
        snap = snapshot if snapshot is not None else self.arena_snapshot()
        [ces] = self._enumerate_batch([int(position)], query, strategy, snap)
        return ces

    def _enumerate_batch(self, hits, query, strategy, snap,
                         oracle: bool = False
                         ) -> List[List[ComplexEvent]]:
        """One frontier-vectorized walk over global hit positions (the
        roots are keyed by position and carry their lane)."""
        post = tecs_arena.resolve_enum_strategy(self.engine, strategy)
        latest = (self._latest_q is not None
                  and float(self._latest_q[query]) > 0.5)
        lanes, roots, ends, thrs = [], [], [], []
        for p in hits:
            rec = self._roots.get(int(p))
            # a repack that added a query leaves NULL roots on older hits
            root = int(rec[1][query]) if rec is not None else -1
            lanes.append(int(rec[0]) if rec is not None else 0)
            roots.append(root)
            ends.append(int(p))
            thrs.append(int(snap.maxs[lanes[-1], root])
                        if latest and root >= 0 else None)
        batches = snap.enumerate_batch(lanes, roots, ends, thrs,
                                       oracle=oracle)
        if post is not None:
            batches = [apply_strategy(post, ces) for ces in batches]
        return batches

    def enumerate_hits(self, hits: Sequence[int], *, query: int = 0,
                       strategy: Optional[str] = None,
                       oracle: bool = False):
        """Enumerate global hit positions with one delta fetch and one
        frontier-vectorized walk over all roots."""
        snap = self.arena_snapshot()
        batches = self._enumerate_batch(hits, query, strategy, snap,
                                        oracle=oracle)
        return {int(p): ces for p, ces in zip(hits, batches)}

    # ------------------------------------------------------------------
    def feed_attrs(self, attrs, event_ts=None):
        """Not available here: the partitioned step needs each event's key
        hash beside its attributes — use :meth:`feed` or
        :meth:`feed_keyed`."""
        raise TypeError("PartitionedStreamingEngine routes by key: use "
                        "feed(events) or feed_keyed(attrs, keys) instead of "
                        "feed_attrs")

    @property
    def state(self):
        """The device state ``{C, lane_keys (L,) uint32, lane_pos (L,),
        lane_last (L,)[, arena]}``, updated in place by every feed."""
        return self._state

    @property
    def num_active_lanes(self) -> int:
        """Lanes currently owned by a partition."""
        return int((self._lane_keys_np() != np.uint32(EMPTY_LANE)).sum())

    def evict_idle(self, min_idle_chunks: int = 1) -> int:
        """Free the lanes whose partition saw no event for at least
        ``min_idle_chunks`` chunks (a lane used in the latest chunk has been
        idle for 0).  Their partitions restart from scratch if the key
        returns.  Returns the number of lanes freed."""
        ll = self._state["lane_last"].cpu().numpy()
        ev = (self._lane_keys_np() != np.uint32(EMPTY_LANE)) & \
            (self._chunk_idx - 1 - ll >= min_idle_chunks)
        n = int(ev.sum())
        if n == 0:
            return 0
        mask = torch.from_numpy(ev).to(self.device)
        self._reset_lanes(mask)
        self._state["lane_keys"].view(torch.int32).masked_fill_(
            mask, _EMPTY_BITS)
        self._state["lane_last"].masked_fill_(mask, -1)
        self.stats.evicted_lanes += n
        return n

    # ------------------------------------------------------------------
    # snapshots and elastic lane rescale
    # ------------------------------------------------------------------
    # the lane count is elastic (restore migrates lane rows), so "batch" is
    # not a compatibility key; lane_cap and the key set shape routing
    _compat_keys = ("format", "engine", "query_fingerprint", "window",
                    "chunk_len", "lane_cap", "key_attrs", "num_states",
                    "num_queries", "arena_capacity", "semantics")

    def manifest(self) -> dict:
        m = super().manifest()
        m.update({
            "num_lanes": int(self.num_lanes),
            "lane_cap": int(self.lane_cap),
            "evict": self.evict,
            "key_attrs": list(self.key_attrs),
            "chunk_idx": int(self._chunk_idx),
            "stats": asdict(self.stats),
            "hash_to_key": _encode_hash_to_key(self._hash_to_key),
            "fallback_clock": {str(h): int(n)
                               for h, n in self._fallback_clock.items()},
        })
        return m

    def _snapshot_roots(self, arrays: Dict[str, np.ndarray]) -> None:
        # keys are bare global positions; each root carries its lane, which
        # a rescaled restore remaps
        keys = sorted(self._roots)
        if keys:
            arrays["roots_key"] = np.asarray(keys, np.int64)
            arrays["roots_lane"] = np.asarray(
                [self._roots[k][0] for k in keys], np.int32)
            arrays["roots_val"] = np.stack(
                [np.asarray(self._roots[k][1], np.int32) for k in keys])

    def _restore_roots(self, arrays: Dict[str, np.ndarray],
                       lane_map: Optional[Dict[int, int]] = None) -> int:
        self._roots.clear()
        if "roots_key" not in arrays:
            return 0
        dropped = 0
        for p, l, v in zip(arrays["roots_key"], arrays["roots_lane"],
                           arrays["roots_val"]):
            lane = int(l)
            if lane_map is not None:
                lane = lane_map.get(lane, -1)
                if lane < 0:         # the shrink dropped the root's lane
                    dropped += 1
                    continue
            self._roots[int(p)] = (lane, np.asarray(v, np.int32))
        return dropped

    def _ring_migration_frame(self, meta: dict,
                              arrays: Dict[str, np.ndarray]) -> np.ndarray:
        """Per-lane frame for the ring remap.  Lane cursors are carried mod
        the old ring, so any representative congruent mod W0 gives the
        same slot↔start pairing; ``lane_pos + W0`` makes every old slot a
        non-negative start.  The cursor is rewritten into the new ring's
        frame (in ``arrays``), so seeding after the restore agrees with the
        moved slots."""
        old_ring = int((meta.get("window") or {}).get("ring",
                                                      self.window.ring))
        lp = np.asarray(arrays["state/lane_pos"], np.int64)
        arrays["state/lane_pos"] = (
            (lp + old_ring) % self.window.ring).astype(np.int32)
        return lp + old_ring

    def quarantine(self, lanes: Sequence[int]) -> None:
        super().quarantine(lanes)
        self.stats.quarantined_lanes = len(self._quarantined)

    def clear_quarantine(self) -> None:
        super().clear_quarantine()
        self.stats.quarantined_lanes = 0

    def restore(self, snapshot: dict, *,
                n_lanes: Optional[int] = None,
                migrate_packing: bool = False,
                max_window_events: Optional[int] = None) -> None:
        """Load a :meth:`snapshot` (of either package), optionally at
        ``n_lanes`` lanes.

        The lane count is elastic: a snapshot of L0 lanes restores onto
        L1 ≠ L0 by gathering every per-lane leaf onto the new lane axis
        (:meth:`_migrate_lanes`).  ``migrate_packing=True`` first remaps
        the packed state axis between query packings;
        ``max_window_events=…`` regrows a time window's ring.  The rest of
        the manifest must match, or the call raises before the state
        changes.
        """
        meta, arrays = snapshot["meta"], dict(snapshot["arrays"])
        skip: Tuple[str, ...] = ()
        if migrate_packing:
            skip = tuple(self._packing_elastic_keys)
            arrays = dict(self._migrated_arrays(
                {"meta": meta, "arrays": arrays}))
        ring = self.window.ring
        arrays = self._ring_migrated(meta, arrays, max_window_events, skip)
        lanes = self.num_lanes if n_lanes is None else int(n_lanes)
        rebuild = lanes != self.num_lanes or self.window.ring != ring
        self.num_lanes = self.batch = lanes
        lane_map = None
        dropped_owned = 0
        src_lanes = int(meta.get("num_lanes", self.num_lanes))
        if src_lanes != self.num_lanes:
            arrays, lane_map, dropped_owned = self._migrate_lanes(
                arrays, src_lanes)
        self._state = _restore_into(
            self._init_full_state(lanes) if rebuild else self._state, arrays)
        # the restored node rows replace the store: refetch from row 0
        self._arena_mirror.invalidate()
        self._pos = int(meta["pos"])
        self._chunk_idx = int(meta["chunk_idx"])
        self._last_ts = (np.asarray(arrays["last_ts"], np.float32)
                         if "last_ts" in arrays else None)
        self.stats = PartitionStats(**meta.get("stats", {}))
        self.stats.evicted_lanes += dropped_owned
        htk = meta.get("hash_to_key")
        self._hash_to_key = ({int(h): tuple(k) for h, k in htk}
                             if htk else {})
        self._fallback_clock = {int(h): int(n) for h, n in
                                meta.get("fallback_clock", {}).items()}
        self._restore_roots(arrays, lane_map)
        q = [int(b) for b in meta.get("quarantined_lanes", ())]
        if lane_map is not None:   # rescale: follow the parked lanes
            q = [lane_map[b] for b in q if b in lane_map]
        self._quarantined = tuple(sorted(q))
        self.stats.quarantined_lanes = len(self._quarantined)

    def _migrate_lanes(self, arrays: Dict[str, np.ndarray], src_lanes: int
                       ) -> Tuple[Dict[str, np.ndarray], Dict[int, int],
                                  int]:
        """Gather the per-lane snapshot leaves onto this engine's lanes.

        Every state leaf has the lane as its leading axis, so a rescale is
        one row gather.  Kept: lanes owned by a partition, then unowned
        lanes whose arena holds nodes (``ptr > 0``, behind recorded
        roots).  A shrink keeps owned lanes by recency (``lane_last``
        descending) and counts the dropped owned lanes as evictions.  Kept
        lanes stay in their relative order.  Each leaf's trailing shape
        and dtype must equal this engine's.
        """
        dst = self.num_lanes
        lk = arrays.get("state/lane_keys")
        ll = arrays.get("state/lane_last")
        if lk is None or ll is None or np.shape(lk) != (src_lanes,):
            raise ValueError(
                f"snapshot lane table does not match its manifest "
                f"num_lanes={src_lanes}")
        owned = np.asarray(lk) != np.uint32(EMPTY_LANE)
        hist = np.zeros(src_lanes, bool)
        ptr = arrays.get("state/arena/ptr")
        if self.arena_capacity is not None and ptr is not None:
            hist = np.asarray(ptr) > 0
        ll = np.asarray(ll)
        order = sorted(np.nonzero(owned | hist)[0],
                       key=lambda i: (0 if owned[i] else 1,
                                      -int(ll[i]), int(i)))
        keep = sorted(int(i) for i in order[:dst])
        dropped_owned = int(sum(1 for i in order[dst:] if owned[i]))
        lane_map = {o: i for i, o in enumerate(keep)}
        tmpl: Dict[str, np.ndarray] = {}
        _flatten_state("state", self._init_lane_state(dst, device="cpu"),
                       tmpl)
        out = {k: v for k, v in arrays.items()
               if not k.startswith("state/")}
        idx = np.asarray(keep, np.int64)
        for key, tv in tmpl.items():
            old = arrays.get(key)
            if old is None:
                raise ValueError(f"snapshot is missing state leaf {key!r}")
            old = np.asarray(old)
            if old.shape[1:] != tv.shape[1:] or old.dtype != tv.dtype:
                raise ValueError(
                    f"snapshot state leaf {key!r} is {old.shape}/"
                    f"{old.dtype}; rescale expects trailing dims "
                    f"{tv.shape[1:]}/{tv.dtype}")
            new = np.array(tv)           # init values on surplus new lanes
            new[:len(idx)] = old[idx]
            out[key] = new
        return out, lane_map, dropped_owned

    def reset(self) -> None:
        """Drop all partitions and rewind the stream position (the state
        buffers are kept)."""
        st = self._state
        self._reset_lanes(torch.ones((self.num_lanes,), dtype=torch.bool,
                                     device=self.device))
        st["lane_keys"].view(torch.int32).fill_(_EMPTY_BITS)
        st["lane_last"].fill_(-1)
        if self.arena_capacity is not None:
            tecs_arena.reset_arena(st["arena"])
        self._pos = 0
        self._chunk_idx = 0
        self._hash_to_key.clear()
        self._fallback_clock.clear()
        self._roots.clear()
        self._arena_mirror.invalidate()
        self._last_ts = None
        self._quarantined = ()
        self.stats = PartitionStats()
