"""Streaming CER runtime: fixed-size chunks over unbounded streams.

:class:`StreamingVectorEngine` feeds ``(chunk_len, B)`` chunks through the
fused pipeline:

* **Preallocated state** — the ``(B, W, S)`` run-count ring (and, for time
  windows, the timestamp ring and ``ovf`` latches) lives in device buffers
  allocated once and updated in place by every feed.
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

from ..core.events import Event
from ..kernels import ops
from ..kernels import window as wkern
from ..kernels.fused_scan import KERNEL

#: snapshot layout version (the reference package's)
SNAPSHOT_FORMAT = 1

#: snapshot leaves whose axis 1 is the window ring
_RING_LEAVES = ("state", "state/C", "state/ts")

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
    empty (zeros, or ``TS_EMPTY`` for the timestamp ring).  Leaves without
    a ring axis pass through.
    """
    if new_ring == old_ring:
        return dict(arrays)
    new_slot, valid = wkern.ring_slot_remap(old_ring, new_ring, next_pos)
    k = np.arange(old_ring)
    out: Dict[str, np.ndarray] = {}
    for name, arr in arrays.items():
        if name not in _RING_LEAVES:
            out[name] = arr
            continue
        fill = (arr.dtype.type(wkern.TS_EMPTY) if name.endswith("/ts")
                else arr.dtype.type(0))
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


def _restore_like(prefix: str, template, arrays: Dict[str, np.ndarray]):
    """Tensors shaped like ``template`` from saved leaves; shape or dtype
    mismatches raise."""
    if isinstance(template, dict):
        return {k: _restore_like(f"{prefix}/{k}", template[k], arrays)
                for k in template}
    arr = arrays.get(prefix)
    if arr is None:
        raise ValueError(f"snapshot is missing state leaf {prefix!r}")
    arr = np.asarray(arr)
    want = template.cpu().numpy()
    if tuple(arr.shape) != want.shape or arr.dtype != want.dtype:
        raise ValueError(
            f"snapshot state leaf {prefix!r} is {arr.shape}/{arr.dtype}, "
            f"this engine expects {want.shape}/{want.dtype} — restore onto "
            "a matching engine (same query, window)")
    # a copy: the engine updates its state in place, and the snapshot's
    # arrays (possibly read-only views) stay the caller's
    return torch.from_numpy(np.array(arr)).to(template.device)


class StreamingVectorEngine:
    """Fixed-chunk streaming wrapper around the fused device pipeline."""

    _compat_keys = ("format", "engine", "query_fingerprint", "window",
                    "chunk_len", "batch", "num_states", "num_queries",
                    "arena_capacity", "semantics")

    def __init__(self, engine, chunk_len: int, batch: int,
                 impl: Optional[str] = None,
                 arena_capacity: Optional[int] = None,
                 strict_overflow: bool = False):
        """``engine``: a constructed :class:`VectorEngine`; its device is
        the stream's.

        chunk_len: events per :meth:`feed` — fixed.
        batch:     number of parallel substreams (lanes).
        strict_overflow: raise :class:`~repro_torch.kernels.window.
                   WindowOverflowError` after a feed in which a time
                   window's ``ovf`` latch tripped.
        """
        if isinstance(engine, str):
            raise TypeError("pass a constructed VectorEngine (a bare query "
                            "string has no window)")
        if arena_capacity is not None:
            raise NotImplementedError("arena_capacity (enumeration through "
                                      "the tECS arena) is " + _NOT_PORTED)
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
        self._ring = engine.ring
        self._pos = 0
        self.strict_overflow = bool(strict_overflow)
        # time windows: each lane's last timestamp, for the monotone audit
        self._last_ts: Optional[np.ndarray] = None
        self._state = self.engine.init_state(self.batch)

    # ------------------------------------------------------------------
    @property
    def position(self) -> int:
        """Absolute stream position of the next event to arrive."""
        return self._pos

    @property
    def state(self):
        """The device state: the (B, W, S) ring, or the ``{"C", "ts",
        "ovf"}`` dict.  The next :meth:`feed` updates it in place — clone it
        to keep a copy."""
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
            return KERNEL.loads
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
            "arena_capacity": None,
            "semantics": {
                "strategies": [str(s) for s in self.engine.strategies],
                "consume": [bool(c) for c in self.engine.consumes],
            },
            "strict_overflow": bool(self.strict_overflow),
            "window_overflow": [int(b) for b in
                                np.nonzero(self.window_overflow)[0]],
            "pos": int(self._pos),
        }

    def snapshot(self) -> dict:
        """Host snapshot ``{"arrays": {name: np.ndarray}, "meta": manifest}``
        of the state, the stream cursor and the monotone-audit carry."""
        arrays: Dict[str, np.ndarray] = {}
        _flatten_state("state", self._state, arrays)
        if self._last_ts is not None:
            arrays["last_ts"] = np.asarray(self._last_ts, np.float32)
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
        if new_w.ring != self.window.ring:
            self._apply_ring(new_w)
        if snap_ring != self.window.ring:
            frame = np.full(self.batch, int(meta["pos"]), np.int64)
            arrays = migrate_ring_arrays(arrays, snap_ring,
                                         self.window.ring, frame)
        self._state = _restore_like(
            "state", self.engine.init_state(self.batch), arrays)
        self._pos = int(meta["pos"])
        self._last_ts = (np.asarray(arrays["last_ts"], np.float32)
                         if "last_ts" in arrays else None)

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
        counts_f, _ = ops.cer_pipeline(
            attrs, self._specs, self._class_of, self._class_ind, self._m_all,
            self._finals_q, self._state, init_mask=self._init_mask,
            window=self.window, event_ts=event_ts,
            start_pos=self._pos % self._ring, impl=self.impl,
            latest_q=self._latest_q, consume_sq=self._consume_sq,
            inplace=True)
        self._pos += T
        counts = counts_f[:, :, 0].cpu().numpy().astype(np.int64)
        hits = [(t0 + int(t), int(b)) for t, b in zip(*np.nonzero(counts))]
        self._check_overflow()
        return counts, hits

    def _check_overflow(self) -> None:
        if not self.strict_overflow:
            return
        ovf = self.window_overflow
        if ovf.any():
            raise wkern.WindowOverflowError(np.nonzero(ovf)[0])

    def reset(self) -> None:
        """Drop all live runs and rewind the stream position."""
        if isinstance(self._state, dict):
            self._state["C"].zero_()
            self._state["ts"].fill_(wkern.TS_EMPTY)
            self._state["ovf"].zero_()
        else:
            self._state.zero_()
        self._pos = 0
        self._last_ts = None
