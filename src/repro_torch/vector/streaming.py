"""Streaming CER runtime: fixed-size chunks over unbounded streams.

:class:`StreamingVectorEngine` feeds ``(chunk_len, B)`` chunks through the
fused pipeline:

* **Preallocated state** — the ``(B, W, S)`` run-count ring (and, for time
  windows, the timestamp ring and ``ovf`` latches) lives in device buffers
  allocated once and updated in place by every feed.
* **Device tECS arena** — with ``arena_capacity`` set, each feed also
  maintains the enumeration structure on the device (``{"C", "arena"}``
  state): :meth:`feed` records a root per hit, and :meth:`enumerate_hits`
  fetches the node store by delta into a host mirror and walks Algorithm 2
  (output-linear delay, no event replay).
* **Ring-relative position** — the kernel receives ``position % ring``, so
  the absolute position stays a host integer and the int32 operand cannot
  overflow on long streams.
* **One kernel library** — :attr:`compile_count` counts builds and loads of
  the kernel library in this process, which stays 1 across chunks.

Snapshots (:meth:`snapshot` / :meth:`restore`) use the reference package's
layout and manifest, so a snapshot taken by either package restores into
the other.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.events import ComplexEvent, Event
from ..core.selection import apply_strategy
from ..kernels import ops
from ..kernels import window as wkern
from ..kernels.build import LIBRARY
from . import tecs_arena

_I32_MAX = np.iinfo(np.int32).max

#: snapshot layout version (the reference package's)
SNAPSHOT_FORMAT = 1

#: snapshot leaves whose axis 1 is the window ring (``…/arena/cell`` too)
_RING_LEAVES = ("state", "state/C", "state/C/C", "state/ts", "state/C/ts")

_NOT_PORTED = "not ported yet: see ROADMAP.md, Queue 1"


def _flatten_state(prefix: str, tree, out: Dict[str, np.ndarray]) -> None:
    """Flatten a state tree of (nested) dicts into host arrays named by
    their sorted key paths joined with ``/``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten_state(f"{prefix}/{k}", tree[k], out)
    else:
        out[prefix] = tree.cpu().numpy().copy()


def migrate_ring_arrays(arrays: Dict[str, np.ndarray], old_ring: int,
                        new_ring: int, next_pos: np.ndarray
                        ) -> Dict[str, np.ndarray]:
    """Scatter ring-indexed snapshot leaves onto a larger ring (regrow).

    Slot ``k`` moves to ``j mod W1`` per
    :func:`repro_torch.kernels.window.ring_slot_remap`; surplus slots start
    empty (zeros, ``TS_EMPTY`` for the timestamp ring, NULL for the arena
    cell table).  Leaves without a ring axis (node stores, pointers, roots)
    pass through.
    """
    if new_ring == old_ring:
        return dict(arrays)
    new_slot, valid = wkern.ring_slot_remap(old_ring, new_ring, next_pos)
    k = np.arange(old_ring)
    out: Dict[str, np.ndarray] = {}
    for name, arr in arrays.items():
        if name in _RING_LEAVES:
            fill = (arr.dtype.type(wkern.TS_EMPTY) if name.endswith("/ts")
                    else arr.dtype.type(0))
        elif name.endswith("/arena/cell"):
            fill = arr.dtype.type(tecs_arena.NULL)
        else:
            out[name] = arr
            continue
        if arr.ndim < 2 or arr.shape[1] != old_ring:
            raise ValueError(
                f"snapshot leaf {name!r} has shape {arr.shape}; ring "
                f"migration expects axis 1 == {old_ring}")
        B = arr.shape[0]
        new = np.full((B, new_ring) + arr.shape[2:], fill, arr.dtype)
        for b in range(B):
            vb = valid[b]
            new[b, new_slot[b, vb]] = arr[b, k[vb]]
        out[name] = new
    return out


def _leaves(prefix: str, template, arrays: Dict[str, np.ndarray],
            out: List[Tuple[torch.Tensor, np.ndarray]]) -> None:
    """Pair each tensor of ``template`` with its saved leaf; shape or dtype
    mismatches raise."""
    if isinstance(template, dict):
        for k in template:
            _leaves(f"{prefix}/{k}", template[k], arrays, out)
        return
    arr = arrays.get(prefix)
    if arr is None:
        raise ValueError(f"snapshot is missing state leaf {prefix!r}")
    arr = np.asarray(arr)
    want = (tuple(template.shape),
            np.dtype(str(template.dtype).replace("torch.", "")))
    if (tuple(arr.shape), arr.dtype) != want:
        raise ValueError(
            f"snapshot state leaf {prefix!r} is {arr.shape}/{arr.dtype}, "
            f"this engine expects {want[0]}/{want[1]} — restore onto "
            "a matching engine (same query, window, capacities)")
    out.append((template, arr))


def _restore_into(template, arrays: Dict[str, np.ndarray]):
    """Copy the saved ``state/…`` leaves into ``template``'s tensors (all
    checked before any is written) and return it."""
    pairs: List[Tuple[torch.Tensor, np.ndarray]] = []
    _leaves("state", template, arrays, pairs)
    for t, arr in pairs:
        t.copy_(torch.from_numpy(np.array(arr)))
    return template


class StreamingVectorEngine:
    """Fixed-chunk streaming wrapper around the fused device pipeline."""

    _compat_keys = ("format", "engine", "query_fingerprint", "window",
                    "chunk_len", "batch", "num_states", "num_queries",
                    "arena_capacity", "semantics")

    def __init__(self, engine, chunk_len: int, batch: int,
                 impl: Optional[str] = None,
                 arena_capacity: Optional[int] = None,
                 arena_impl: Optional[str] = None,
                 strict_overflow: bool = False):
        """``engine``: a constructed :class:`VectorEngine`; its device is
        the stream's.

        chunk_len: events per :meth:`feed` — fixed.
        batch:     number of parallel substreams (lanes).
        arena_capacity: when set, each feed also maintains the device tECS
                   arena (``arena_capacity`` node slots per lane), and hits
                   become enumerable through :meth:`enumerate_hits`.
        arena_impl: "block" (the builder kernel route) or "fold" (the
                   per-event reference fold); default: the engine's.
        strict_overflow: raise :class:`~repro_torch.kernels.window.
                   WindowOverflowError` after a feed in which a time
                   window's ``ovf`` latch tripped.
        """
        if isinstance(engine, str):
            raise TypeError("pass a constructed VectorEngine (a bare query "
                            "string has no window)")
        self.engine = engine
        self.encoder = engine.encoder
        self.device = engine.device
        self.epsilon = engine.epsilon
        self.window = engine.window
        self.chunk_len = int(chunk_len)
        self.batch = int(batch)
        self.impl = impl if impl is not None else engine.impl
        t = engine.tables
        self._finals_q = t.finals[None, :]
        self._init_mask = t.init_mask
        self._class_of = t.class_of
        self._class_ind = t.class_ind
        self._m_all = t.m_all
        self._specs = self.encoder.specs
        self._latest_q = t.latest_q
        self._consume_sq = t.consume_sq
        # the kernel gets position % ring, so the absolute position stays a
        # host int; arena node labels are absolute int32 positions, so with
        # an arena feed() refuses past 2^31 - 1 events between resets
        self._ring = engine.ring
        self._pos = 0
        self.strict_overflow = bool(strict_overflow)
        self.arena_capacity = arena_capacity
        self.arena_impl = tecs_arena.check_arena_impl(
            arena_impl if arena_impl is not None
            else getattr(engine, "arena_impl", "block"))
        self._arena_tables = (engine.arena_tables()
                              if arena_capacity is not None else None)
        self._roots: Dict[Tuple[int, int], np.ndarray] = {}
        # host mirror of the node store: enumeration fetches only the delta
        self._arena_mirror = tecs_arena.ArenaMirror()
        # time windows: each lane's last timestamp, for the monotone audit
        self._last_ts: Optional[np.ndarray] = None
        self._state = self._init_full_state()

    def _init_full_state(self):
        C = self.engine.init_state(self.batch)
        if self.arena_capacity is None:
            return C
        return {"C": C, "arena": tecs_arena.init_arena(
            self.batch, self.arena_capacity, self._ring,
            self._arena_tables.num_states, device=self.device)}

    # ------------------------------------------------------------------
    @property
    def position(self) -> int:
        """Absolute stream position of the next event to arrive."""
        return self._pos

    @property
    def state(self):
        """The device state: the (B, W, S) ring, or the ``{"C", "ts",
        "ovf"}`` dict; with ``arena_capacity`` set, ``{"C": <that>,
        "arena": <node store>}``.  The next :meth:`feed` updates it in
        place — clone it to keep a copy."""
        return self._state

    @property
    def window_overflow(self) -> np.ndarray:
        """Per-lane latched time-window rate-bound flags (all-False for
        count windows)."""
        return wkern.window_overflow(self._state)

    @property
    def compile_count(self) -> int:
        """Builds and loads of the kernel library in this process (1 once a
        kernel feed ran, 0 on the plain route)."""
        if self.impl == "fused" and self.device.type == "cuda":
            return LIBRARY.loads
        return 0

    # ------------------------------------------------------------------
    def query_fingerprint(self) -> str:
        """Deterministic digest of the compiled tables and the encoder
        layout — byte-identical to the reference package's, so snapshots
        of one package are recognised by the other."""
        h = hashlib.sha256()
        enc = self.encoder
        h.update(repr((enc.attrs, enc.specs,
                       sorted((a, sorted(v.items()))
                              for a, v in enc.vocab.items()))).encode())
        for arr in (self._m_all, self._finals_q, self._class_of,
                    self._init_mask):
            a = arr.cpu().numpy()
            h.update(str((a.shape, str(a.dtype))).encode())
            h.update(a.tobytes())
        # hashed only when present, so plain ALL engines keep the base digest
        if self._latest_q is not None or self._consume_sq is not None:
            h.update(b"semantics")
            for arr in (self._latest_q, self._consume_sq):
                if arr is None:
                    h.update(b"none")
                else:
                    a = arr.cpu().numpy()
                    h.update(str((a.shape, str(a.dtype))).encode())
                    h.update(a.tobytes())
        return h.hexdigest()

    def manifest(self) -> dict:
        """Restore-compatibility manifest (JSON-able)."""
        w = self.window
        return {
            "format": SNAPSHOT_FORMAT,
            "engine": type(self).__name__,
            "query_fingerprint": self.query_fingerprint(),
            "window": {"kind": w.kind, "size": float(w.size),
                       "time_attr": w.time_attr, "ring": int(w.ring)},
            "chunk_len": int(self.chunk_len),
            "batch": int(self.batch),
            "num_states": int(self._finals_q.shape[-1]),
            "num_queries": int(self._finals_q.shape[0]),
            "arena_capacity": (None if self.arena_capacity is None
                               else int(self.arena_capacity)),
            "semantics": {
                "strategies": [str(s) for s in self.engine.strategies],
                "consume": [bool(c) for c in self.engine.consumes],
            },
            "strict_overflow": bool(self.strict_overflow),
            "window_overflow": [int(b) for b in
                                np.nonzero(self.window_overflow)[0]],
            "pos": int(self._pos),
            "num_roots": len(self._roots),
        }

    def snapshot(self) -> dict:
        """Host snapshot ``{"arrays": {name: np.ndarray}, "meta": manifest}``
        of the state (arena included), the stream cursor, the monotone-audit
        carry and the recorded enumeration roots."""
        arrays: Dict[str, np.ndarray] = {}
        _flatten_state("state", self._state, arrays)
        if self._last_ts is not None:
            arrays["last_ts"] = np.asarray(self._last_ts, np.float32)
        keys = sorted(self._roots)
        if keys:
            arrays["roots_key"] = np.asarray(keys, np.int64)      # (N, 2)
            arrays["roots_val"] = np.stack(
                [np.asarray(self._roots[k], np.int32) for k in keys])
        return {"arrays": arrays, "meta": self.manifest()}

    def _check_manifest(self, meta: dict, skip: Sequence[str] = ()) -> None:
        mine = self.manifest()
        bad = [f"{k}: snapshot {meta.get(k)!r} != engine {mine[k]!r}"
               for k in self._compat_keys
               if k not in skip and meta.get(k) != mine[k]]
        if bad:
            raise ValueError(
                "snapshot is incompatible with this engine — restoring "
                "would silently corrupt state:\n  " + "\n  ".join(bad))

    def _check_window_elastic(self, meta: dict, target_ring: int) -> None:
        """Kind, size and time_attr must match; only the ring may grow."""
        w = self.window
        sw = meta.get("window") or {}
        mismatch = [k for k, v in (("kind", w.kind), ("size", float(w.size)),
                                   ("time_attr", w.time_attr))
                    if sw.get(k) != v]
        if mismatch:
            raise ValueError(
                f"snapshot window {sw!r} is incompatible with this engine "
                f"(kind={w.kind!r} size={w.size} time_attr={w.time_attr!r})"
                " — only the ring (rate bound) is elastic")
        if int(sw.get("ring", target_ring)) > target_ring:
            raise ValueError(
                f"ring regrow cannot shrink: snapshot ring "
                f"{int(sw['ring'])} > engine ring {target_ring}")

    def _apply_ring(self, new_window: "wkern.DeviceWindow") -> None:
        """Point this engine and the wrapped engine at a regrown window.
        The wrapped engine is mutated — regrow only an engine you own."""
        self.engine.window = new_window
        self.engine.ring = new_window.ring
        self.engine.epsilon = new_window.epsilon
        self.window = new_window
        self.epsilon = new_window.epsilon
        self._ring = new_window.ring

    def restore(self, snapshot: dict, *, migrate_packing: bool = False,
                max_window_events: Optional[int] = None) -> None:
        """Load a :meth:`snapshot` (of either package) into this engine.

        The manifest is checked first; a mismatch raises without touching
        state.  ``max_window_events=`` grows a time window's ring while
        restoring: live starts move to slot ``j mod W1`` and the engine
        continues exactly like one built with the wider ring.
        """
        if migrate_packing:
            raise NotImplementedError("migrate_packing (packed multi-query "
                                      "engines) is " + _NOT_PORTED)
        meta, arrays = snapshot["meta"], dict(snapshot["arrays"])
        skip: Tuple[str, ...] = ()
        snap_ring = int((meta.get("window") or {}).get("ring",
                                                      self.window.ring))
        new_w = (self.window.regrow(max_window_events)
                 if max_window_events is not None else self.window)
        if new_w.ring < snap_ring:
            raise ValueError(
                f"restore(max_window_events={int(max_window_events)}) pads "
                f"to ring {new_w.ring} < snapshot ring {snap_ring} — ring "
                "regrow cannot shrink")
        if snap_ring != new_w.ring:
            self._check_window_elastic(meta, target_ring=new_w.ring)
            skip = ("window",)
        self._check_manifest(meta, skip=skip)
        regrown = new_w.ring != self.window.ring
        if regrown:
            self._apply_ring(new_w)
        if snap_ring != self.window.ring:
            frame = np.full(self.batch, int(meta["pos"]), np.int64)
            arrays = migrate_ring_arrays(arrays, snap_ring,
                                         self.window.ring, frame)
        # a regrown ring needs new buffers; otherwise restore in place
        self._state = _restore_into(
            self._init_full_state() if regrown else self._state, arrays)
        # the restored node rows replace the store: refetch from row 0
        self._arena_mirror.invalidate()
        self._pos = int(meta["pos"])
        self._last_ts = (np.asarray(arrays["last_ts"], np.float32)
                         if "last_ts" in arrays else None)
        self._roots.clear()
        if "roots_key" in arrays:
            for k, v in zip(arrays["roots_key"], arrays["roots_val"]):
                self._roots[(int(k[0]), int(k[1]))] = np.asarray(v, np.int32)

    def regrow(self, max_window_events: int) -> None:
        """Grow this time window's per-lane rate bound in place (snapshot,
        then a ring-migrating :meth:`restore`).  No-op when the target pads
        to the current ring; raises on count windows and on shrinking."""
        if self.window.regrow(max_window_events).ring == self.window.ring:
            return
        self.restore(self.snapshot(), max_window_events=max_window_events)

    # ------------------------------------------------------------------
    def feed(self, streams: Sequence[Sequence[Event]]
             ) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
        """Feed one chunk of B streams × chunk_len events.

        Returns ``(counts, hits)``: counts ``(chunk_len, B)`` int64 match
        counts per position; hits the absolute ``(position, stream)`` pairs
        with ≥ 1 match.
        """
        if self.window.is_time:
            attrs, ts = self.encoder.encode_streams_ts(
                streams, self.window.time_attr, base_pos=self._pos)
            return self.feed_attrs(torch.from_numpy(attrs).to(self.device),
                                   torch.from_numpy(ts).to(self.device))
        attrs = self.encoder.encode_streams(streams)
        return self.feed_attrs(torch.from_numpy(attrs).to(self.device))

    def feed_attrs(self, attrs: torch.Tensor, event_ts=None
                   ) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
        """Device-tensor entry point: attrs (chunk_len, B, A) f32 on the
        engine's device; time windows also take ``event_ts (chunk_len, B)``
        f32, monotone in stream order (audited across feeds)."""
        T, B = attrs.shape[0], attrs.shape[1]
        if T != self.chunk_len or B != self.batch:
            raise ValueError(
                f"streaming chunk must be (chunk_len={self.chunk_len}, "
                f"batch={self.batch}, A); got (T={T}, B={B}).  Pad the tail "
                "chunk on the host or build a second engine for remainders")
        if self.window.is_time:
            if event_ts is None:
                raise ValueError("time-window feeds need the event_ts "
                                 "(chunk_len, B) operand")
            self._last_ts = wkern.audit_monotone_ts(event_ts, self._last_ts)
        elif event_ts is not None:
            raise ValueError("event_ts was passed but the query window is "
                             "count-based")
        t0 = self._pos
        kw = dict(window=self.window, event_ts=event_ts,
                  impl=self.impl, latest_q=self._latest_q,
                  consume_sq=self._consume_sq, inplace=True)
        roots = None
        if self.arena_capacity is None:
            counts_f, _ = ops.cer_pipeline(
                attrs, self._specs, self._class_of, self._class_ind,
                self._m_all, self._finals_q, self._state,
                init_mask=self._init_mask, start_pos=self._pos % self._ring,
                **kw)
        else:
            if self._pos + T > _I32_MAX:
                raise ValueError(
                    f"arena node labels are int32 stream positions; "
                    f"position {self._pos + T} exceeds {_I32_MAX}.  reset() "
                    "the engine (its arena would long since have "
                    "overflowed its capacity anyway)")
            counts_f, _, _, roots = tecs_arena.scan_chunk(
                self._arena_tables, self._state["arena"], attrs,
                self._state["C"], specs=self._specs,
                class_of=self._class_of, class_ind=self._class_ind,
                m_all=self._m_all, finals_q=self._finals_q,
                init_mask=self._init_mask, start=self._pos % self._ring,
                gbase=self._pos, arena_impl=self.arena_impl, **kw)
        self._pos += T
        counts = counts_f[:, :, 0].cpu().numpy().astype(np.int64)
        hits = [(t0 + int(t), int(b)) for t, b in zip(*np.nonzero(counts))]
        if roots is not None:
            roots_np = roots.cpu().numpy()
            for p, b in hits:
                self._roots[(p, b)] = roots_np[p - t0, b]
        self._check_overflow()
        return counts, hits

    def _check_overflow(self) -> None:
        if not self.strict_overflow:
            return
        ovf = self.window_overflow
        if ovf.any():
            raise wkern.WindowOverflowError(np.nonzero(ovf)[0])

    # ------------------------------------------------------------------
    # tECS-arena enumeration (requires arena_capacity)
    # ------------------------------------------------------------------
    def arena_snapshot(self) -> tecs_arena.ArenaSnapshot:
        """Sync the host mirror with the device arena and snapshot it.

        Node ids are stable across feeds, so one snapshot enumerates every
        hit recorded so far; the sync fetches only rows appended since the
        previous one."""
        if self.arena_capacity is None:
            raise ValueError("engine built without arena_capacity — "
                             "no tECS arena to snapshot")
        return self._arena_mirror.sync(self._state["arena"])

    def enumerate(self, position: int, stream: int = 0, query: int = 0,
                  strategy: Optional[str] = None,
                  snapshot: Optional[tecs_arena.ArenaSnapshot] = None
                  ) -> List[ComplexEvent]:
        """Complex events closing at absolute ``position`` on ``stream``.

        Walks Algorithm 2 over the fetched arena (output-linear delay, no
        event replay).  ``strategy=None`` enumerates under the query's
        compiled semantics; an explicit strategy is a host post-filter,
        valid only on plain-ALL engines."""
        snap = snapshot if snapshot is not None else self.arena_snapshot()
        [ces] = self._enumerate_batch(
            [(int(position), int(stream))], query, strategy, snap)
        return ces

    def _enumerate_batch(self, hits, query, strategy, snap,
                         oracle: bool = False
                         ) -> List[List[ComplexEvent]]:
        """One frontier-vectorized walk, one list per (position, stream).

        A compiled-LAST query's matches are the latest-start group, which
        the walk selects when the threshold is the root's own max-start."""
        post = tecs_arena.resolve_enum_strategy(self.engine, strategy)
        latest = (self._latest_q is not None
                  and float(self._latest_q[query]) > 0.5)
        lanes, roots, ends, thrs = [], [], [], []
        for p, b in hits:
            rec = self._roots.get((int(p), int(b)))
            root = int(rec[query]) if rec is not None else -1
            lanes.append(int(b))
            roots.append(root)
            ends.append(int(p))
            thrs.append(int(snap.maxs[int(b), root])
                        if latest and root >= 0 else None)
        batches = snap.enumerate_batch(lanes, roots, ends, thrs,
                                       oracle=oracle)
        if post is not None:
            batches = [apply_strategy(post, ces) for ces in batches]
        return batches

    def enumerate_hits(self, hits: Sequence[Tuple[int, int]],
                       query: int = 0, strategy: Optional[str] = None,
                       oracle: bool = False
                       ) -> Dict[Tuple[int, int], List[ComplexEvent]]:
        """Enumerate a batch of ``(position, stream)`` hits with one delta
        fetch and one frontier-vectorized walk over all roots
        (``oracle=True``: the per-root DFS of Algorithm 2 instead)."""
        snap = self.arena_snapshot()
        batches = self._enumerate_batch(hits, query, strategy, snap,
                                        oracle=oracle)
        return {(int(p), int(b)): ces
                for (p, b), ces in zip(hits, batches)}

    def clear_roots(self, before: Optional[int] = None) -> int:
        """Forget recorded enumeration roots (host bookkeeping): all of
        them, or those at positions ``< before``.  Device nodes stay;
        reclaiming them is :meth:`reset`'s job.  Returns the number
        dropped."""
        if before is None:
            n = len(self._roots)
            self._roots.clear()
            return n
        drop = [k for k in self._roots if k[0] < before]
        for k in drop:
            del self._roots[k]
        return len(drop)

    # ------------------------------------------------------------------
    def reset(self) -> None:
        """Drop all live runs, the arena and the recorded roots, and rewind
        the stream position (the state buffers are kept)."""
        state = self._state
        if self.arena_capacity is not None:
            tecs_arena.reset_arena(state["arena"])
            state = state["C"]
        if isinstance(state, dict):
            state["C"].zero_()
            state["ts"].fill_(wkern.TS_EMPTY)
            state["ovf"].zero_()
        else:
            state.zero_()
        self._pos = 0
        self._last_ts = None
        self._roots.clear()
        self._arena_mirror.invalidate()
