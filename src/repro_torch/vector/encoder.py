"""Host-side event encoding for the device engine.

Events carry typed attributes (strings, ints, floats); the device works on a
dense ``(B, A)`` f32 matrix.  The encoder derives, from the query's atom
registry, (1) the ordered list of referenced attributes and (2) per-attribute
categorical vocabularies for string constants, and produces both the numeric
predicate specs of the fused-scan kernel and the event matrices.  It is the
reference package's encoder, the keyed (PARTITION BY) encodes of one
interleaved stream included.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.events import Event
from ..core.partition import partition_key, stable_key_hash
from ..core.predicates import AtomRegistry
from ..kernels.ref import OP_EQ, OP_GE, OP_GT, OP_LE, OP_LT, OP_NE

_OP_CODE = {"==": OP_EQ, "!=": OP_NE, "<": OP_LT, "<=": OP_LE,
            ">": OP_GT, ">=": OP_GE}

UNSEEN = -1.0  # categorical code for values never mentioned by the query


@dataclass
class EventEncoder:
    attrs: Tuple[str, ...]
    attr_index: Dict[str, int]
    vocab: Dict[str, Dict[str, float]]           # attr -> {string: code}
    specs: Tuple[Tuple[int, int, float], ...]    # (col, op, threshold)

    @staticmethod
    def from_registry(registry: AtomRegistry) -> "EventEncoder":
        attrs: List[str] = []
        attr_index: Dict[str, int] = {}
        vocab: Dict[str, Dict[str, float]] = {}
        specs: List[Tuple[int, int, float]] = []
        for a in registry.atoms:
            if a.attr not in attr_index:
                attr_index[a.attr] = len(attrs)
                attrs.append(a.attr)
            col = attr_index[a.attr]
            if isinstance(a.value, str):
                codes = vocab.setdefault(a.attr, {})
                if a.value not in codes:
                    codes[a.value] = float(len(codes))
                thr = codes[a.value]
            else:
                thr = float(a.value)
            specs.append((col, _OP_CODE[a.op], thr))
        return EventEncoder(tuple(attrs), attr_index, vocab, tuple(specs))

    def encode_event(self, t: Event) -> np.ndarray:
        row = np.zeros(len(self.attrs), dtype=np.float32)
        for a, i in self.attr_index.items():
            v = t.get(a)
            if isinstance(v, str):
                row[i] = self.vocab.get(a, {}).get(v, UNSEEN)
            elif v is None:
                row[i] = np.nan  # NULL: fails every comparison
            else:
                row[i] = float(v)
        return row

    def encode_streams(self, streams: Sequence[Sequence[Event]]) -> np.ndarray:
        """B streams × T events → (T, B, A) f32 (streams must be equal length)."""
        B = len(streams)
        T = len(streams[0])
        out = np.zeros((T, B, len(self.attrs)), dtype=np.float32)
        for b, s in enumerate(streams):
            if len(s) != T:
                raise ValueError("streams must be equal length per batch")
            for t, ev in enumerate(s):
                out[t, b] = self.encode_event(ev)
        return out

    def event_ts(self, ev: Event, time_attr: Optional[str],
                 fallback: Optional[float]) -> float:
        """One event's timestamp, mirroring the host engine's clock rule.

        ``time_attr`` set → read that attribute (``WITHIN 30000
        [stock_time]``); else the event's arrival ``timestamp``; else the
        stream position ``fallback`` (None ⇒ raise: the caller has no
        position-derived clock, e.g. PARTITION BY substreams).
        """
        if time_attr is not None:
            v = ev.get(time_attr)
            if v is None:
                raise ValueError(
                    f"time-window event is NULL on time_attr "
                    f"{time_attr!r}: {ev!r}")
            return float(v)
        if ev.timestamp is not None:
            return float(ev.timestamp)
        if fallback is None:
            raise ValueError(
                "time-window event carries no timestamp and no time_attr "
                f"was declared: {ev!r} — assign timestamps (e.g. "
                "core.events.assign_positions) before feeding")
        return fallback

    def encode_streams_ts(self, streams: Sequence[Sequence[Event]],
                          time_attr: Optional[str] = None,
                          base_pos: Optional[int] = 0
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Time-window variant: → (attrs (T, B, A) f32, ts (T, B) f32).

        The per-event timestamp operand of the device time window: from
        ``time_attr``, else the event's own
        ``timestamp``, else arrival order ``base_pos + t`` — exactly the
        host engine's clock (``core.engine.Engine.process``).
        ``base_pos=None`` disables the arrival-order fallback (no
        position-derived clock exists, e.g. a traced or per-lane start
        offset): events must then carry timestamps.
        """
        attrs = self.encode_streams(streams)
        T, B = attrs.shape[:2]
        ts = np.zeros((T, B), dtype=np.float32)
        for b, s in enumerate(streams):
            for t, ev in enumerate(s):
                ts[t, b] = self.event_ts(
                    ev, time_attr,
                    None if base_pos is None else float(base_pos + t))
        return attrs, ts

    def encode_stream_with_keys(self, events: Sequence[Event],
                                key_attrs: Tuple[str, ...]
                                ) -> Tuple[np.ndarray, np.ndarray]:
        """One interleaved stream → (attrs (T, A) f32, keys (T,) uint32).

        ``keys[t]`` is the stable 32-bit partition hash of event ``t``'s
        PARTITION BY attributes (``core.partition.stable_key_hash``); events
        NULL on any key attribute get the NULL sentinel, which the device
        router drops (they join no substream).  Key attributes need not be
        referenced by the query's predicates — hashing reads the raw values,
        not the encoded matrix.
        """
        T = len(events)
        out = np.zeros((T, len(self.attrs)), dtype=np.float32)
        keys = np.empty((T,), dtype=np.uint32)
        for t, ev in enumerate(events):
            out[t] = self.encode_event(ev)
            keys[t] = stable_key_hash(partition_key(ev, key_attrs))
        return out, keys

    def encode_stream_keyed_ts(self, events: Sequence[Event],
                               key_attrs: Tuple[str, ...],
                               time_attr: Optional[str] = None,
                               clock: Optional[Dict[int, int]] = None
                               ) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
        """Keyed encoding + the timestamp operand (time-window PARTITION
        BY): → (attrs (T, A), keys (T,) uint32, ts (T,)
        f32).  The global stream position is NOT a valid fallback clock
        here — the host engine's clock is the *substream-local* position,
        only known after routing.  ``clock`` supplies exactly that: a
        persistent ``{key_hash: next_rank}`` counter table (owned by the
        caller, carried across chunks and through checkpoints) — each
        non-NULL-key event draws its substream rank from it, so a
        timestamp-less event gets ``float(rank)``, bit-identical to the
        host ``PartitionedEngine``'s per-partition position clock.  With
        ``clock=None`` events must carry timestamps (or ``time_attr``),
        like the host fed through ``assign_positions``.
        NULL-key events join no substream (the host drops them before
        ever reading a clock), so they get a NaN placeholder instead of
        raising — and never consume a rank: the router never scatters
        them to a lane and the monotonicity audit skips NULL-key rows.
        """
        attrs, keys = self.encode_stream_with_keys(events, key_attrs)
        ts = np.empty((len(events),), dtype=np.float32)
        for t, ev in enumerate(events):
            if partition_key(ev, key_attrs) is None:
                ts[t] = np.nan
                continue
            rank = None
            if clock is not None:
                h = int(keys[t])
                rank = clock.get(h, 0)
                clock[h] = rank + 1
            ts[t] = self.event_ts(
                ev, time_attr, None if rank is None else float(rank))
        return attrs, keys, ts
