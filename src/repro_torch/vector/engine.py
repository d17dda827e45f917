"""Device CER engine: recognition, counting and enumeration over B streams.

Per stream position the engine computes the exact number of complex events
closing there, with the windowed counting-semiring scan of
:func:`repro_torch.kernels.ops.cer_pipeline` (the Hopper fused-scan kernel
on CUDA, or the three-kernel unfused path with ``impl="unfused"``; its
halves are :meth:`VectorEngine.classify` and :meth:`VectorEngine.scan`),
and with :meth:`VectorEngine.run_enumerate` also the complex
events themselves, through the device tECS arena
(:mod:`repro_torch.vector.tecs_arena`).  For fixed-size chunks over
unbounded streams use
:class:`repro_torch.vector.streaming.StreamingVectorEngine`.

The B axis carries independent, pre-partitioned substreams;
:meth:`VectorEngine.partitioned_streaming` routes one interleaved stream to
them by key (PARTITION BY).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.events import ComplexEvent, Event
from ..core.query import CompiledQuery, compile_query
from ..kernels import ops
from ..kernels import window as wkern
from . import tecs_arena
from .encoder import EventEncoder
from .symbolic import SymbolicCEA, compile_symbolic

def resolve_device(device=None) -> torch.device:
    """The engine's device: CUDA unless the caller asks for the CPU.

    ``None`` means CUDA and raises ``RuntimeError`` when there is none —
    there is no silent CPU fallback.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch version on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be CUDA or the CPU, got {dev}")
    return dev


def encode_windowed(encoder: EventEncoder, window: "wkern.DeviceWindow",
                    streams, device, base_pos=0):
    """(attrs, event_ts | None) tensors on ``device`` for one feed.

    Time windows encode the ``(T, B)`` f32 timestamp operand and audit
    stream-order monotonicity.  ``base_pos`` anchors the arrival-order
    fallback clock; ``None`` disables it.
    """
    if not window.is_time:
        return torch.from_numpy(encoder.encode_streams(streams)).to(
            device), None
    attrs, ts = encoder.encode_streams_ts(streams, window.time_attr,
                                          base_pos=base_pos)
    wkern.audit_monotone_ts(ts)
    return torch.from_numpy(attrs).to(device), torch.from_numpy(ts).to(
        device)


def _fallback_base(window: "wkern.DeviceWindow", start_pos):
    """Arrival-order clock anchor: the scalar start position, or None when
    ``start_pos`` is a per-lane vector."""
    if not window.is_time:
        return 0
    if isinstance(start_pos, (int, np.integer)):
        return int(start_pos)
    return None


@dataclass
class VectorQueryTables:
    """Device tables of one compiled query.

    ``latest_q`` is the (Q,) f32 LAST flag, ``consume_sq`` the (Q, S) f32
    CONSUME BY ANY state-clear table; both are ``None`` when trivial.
    """

    m_all: torch.Tensor       # (C, S, S) f32
    finals: torch.Tensor      # (S,) f32
    class_of: torch.Tensor    # (2^k,) int32
    class_ind: torch.Tensor   # (≥2^k, C) f32 one-hot form of class_of
    init_mask: torch.Tensor   # (S,) f32 one-hot seed at the initial state
    num_states: int
    num_classes: int
    num_bits: int
    latest_q: Optional[torch.Tensor] = None    # (Q,) f32 | None
    consume_sq: Optional[torch.Tensor] = None  # (Q, S) f32 | None

    @staticmethod
    def from_numpy(m_all, finals, class_of, class_ind, init_mask,
                   latest_q=None, consume_sq=None, *,
                   device) -> "VectorQueryTables":
        """Tables from numpy arrays — for instance the reference package's
        ``VectorQueryTables`` fields passed through ``np.asarray``."""
        def dev(a, dtype):
            return None if a is None else torch.from_numpy(
                np.array(a, dtype)).to(device)

        m_all = np.asarray(m_all, np.float32)
        class_of = np.asarray(class_of, np.int32)
        num_bits = int(class_of.shape[0]).bit_length() - 1
        if class_of.shape != (1 << num_bits,):
            raise ValueError(f"class_of must have 2^k rows, got "
                             f"{class_of.shape}")
        return VectorQueryTables(
            m_all=dev(m_all, np.float32),
            finals=dev(finals, np.float32),
            class_of=dev(class_of, np.int32),
            class_ind=dev(class_ind, np.float32),
            init_mask=dev(init_mask, np.float32),
            num_states=int(m_all.shape[1]),
            num_classes=int(m_all.shape[0]),
            num_bits=num_bits,
            latest_q=dev(latest_q, np.float32),
            consume_sq=dev(consume_sq, np.float32))


class VectorEngine:
    """Device evaluation of a windowed CEQL query over B streams.

    The window comes from the query's ``WITHIN`` clause (count or time);
    ``epsilon=`` must agree with it, or stands in for a missing clause with
    a warning.  ``max_window_events`` sizes a time window's ring.
    ``device=None`` runs on CUDA (``RuntimeError`` without one); pass
    ``device="cpu"`` for the plain PyTorch version.
    """

    def __init__(self, query: Union[str, CompiledQuery],
                 epsilon: Optional[int] = None, impl: Optional[str] = None,
                 max_window_events: Optional[int] = None, device=None,
                 arena_impl: str = "block"):
        self.device = resolve_device(device)
        compiled = compile_query(query) if isinstance(query, str) else query
        self.compiled = compiled
        # unsupported semantics raise here, so a query can never silently
        # run under ANY
        self.semantics = compiled.semantics
        self.strategies = (compiled.query.strategy,)
        self.consumes = (bool(compiled.query.consume_on_match),)
        self.native_semantics = (self.semantics.construction != "ALL"
                                 or self.semantics.latest
                                 or self.semantics.consume)
        self.symbolic: SymbolicCEA = compile_symbolic(
            compiled.cea, strategy=self.semantics.construction)
        self.encoder = EventEncoder.from_registry(compiled.cea.registry)
        self.window = wkern.resolve_window(
            compiled.query.window, epsilon=epsilon,
            max_window_events=max_window_events)
        self.epsilon = self.window.epsilon
        self.ring = self.window.ring
        self.impl = "fused" if impl is None else impl
        if self.impl not in ops.IMPLS:
            raise ValueError(f"impl must be one of {ops.IMPLS}, got "
                             f"{self.impl!r}")
        # "block" (the builder kernel route) or "fold" (the per-event
        # reference fold)
        self.arena_impl = tecs_arena.check_arena_impl(arena_impl)
        sym = self.symbolic
        init_mask = np.zeros(sym.num_states, np.float32)
        init_mask[sym.initial] = 1.0
        sem = self.semantics
        self.tables = VectorQueryTables.from_numpy(
            sym.transition_matrices(), sym.finals, sym.class_of,
            ops.class_indicator(sym.class_of, sym.num_classes).numpy(),
            init_mask,
            latest_q=np.ones((1,), np.float32) if sem.latest else None,
            consume_sq=(np.ones((1, sym.num_states), np.float32)
                        if sem.consume else None),
            device=self.device)

    # ------------------------------------------------------------------
    def init_state(self, batch: int):
        """Fresh scan state on the engine's device: the ``(B, W, S)`` ring,
        or the ``{"C", "ts", "ovf"}`` dict for time windows."""
        return wkern.init_state(self.window, batch, self.tables.num_states,
                                device=self.device)

    def encode(self, streams: Sequence[Sequence[Event]]) -> torch.Tensor:
        """B streams of T events → (T, B, A) f32 attribute tensor."""
        return torch.from_numpy(self.encoder.encode_streams(streams)).to(
            self.device)

    def encode_ts(self, streams: Sequence[Sequence[Event]],
                  base_pos: Optional[int] = 0):
        """→ (attrs (T, B, A), event_ts (T, B) | None) per the window."""
        return encode_windowed(self.encoder, self.window, streams,
                               self.device, base_pos=base_pos)

    # ------------------------------------------------------------------
    def classify(self, attrs: torch.Tensor) -> torch.Tensor:
        """(T, B, A) attributes → (T, B) int32 symbol-class ids (the
        bit-vector kernel on CUDA, then the ``class_of`` gather)."""
        T, B, A = attrs.shape
        bits = ops.bitvector(attrs.reshape(T * B, A), self.encoder.specs)
        return self.tables.class_of[bits.long()].reshape(T, B)

    def scan(self, class_ids: torch.Tensor, state: torch.Tensor,
             start_pos: Union[int, torch.Tensor] = 0
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(T, B) class ids × (B, W, S) state → (matches (T, B), state').

        The count-window scan kernel of the unfused pipeline; time-window
        queries, LAST and CONSUME BY ANY evaluate through
        :meth:`pipeline`."""
        wkern.require_count_scan(self.window)
        if self.tables.latest_q is not None or \
                self.tables.consume_sq is not None:
            raise ValueError(
                "scan() cannot honor LAST / CONSUME BY ANY semantics "
                f"(query strategy {self.compiled.query.strategy!r}); "
                "use pipeline()")
        return ops.cea_scan(class_ids, self.tables.m_all, self.tables.finals,
                            state, epsilon=self.epsilon, start_pos=start_pos)

    def pipeline(self, attrs: torch.Tensor, state,
                 start_pos: Union[int, torch.Tensor] = 0,
                 event_ts: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, object]:
        """(T, B, A) attrs → (matches (T, B), state').  Time windows also
        take ``event_ts (T, B)`` f32 (:meth:`encode_ts`)."""
        t = self.tables
        matches, state = ops.cer_pipeline(
            attrs, self.encoder.specs, t.class_of, t.class_ind, t.m_all,
            t.finals[None, :], state, init_mask=t.init_mask,
            window=self.window, event_ts=event_ts, start_pos=start_pos,
            impl=self.impl, latest_q=t.latest_q, consume_sq=t.consume_sq)
        return matches[:, :, 0], state

    def run(self, streams: Sequence[Sequence[Event]], state=None,
            start_pos: Union[int, torch.Tensor] = 0
            ) -> Tuple[np.ndarray, object]:
        """Host → device → host: (match counts (T, B) int64, final state)."""
        attrs, ts = self.encode_ts(
            streams, base_pos=_fallback_base(self.window, start_pos))
        if state is None:
            state = self.init_state(attrs.shape[1])
        matches, state = self.pipeline(attrs, state, start_pos=start_pos,
                                       event_ts=ts)
        return matches.cpu().numpy().astype(np.int64), state

    def window_overflow(self, state) -> np.ndarray:
        """Per-lane latched rate-bound flags of a returned state."""
        return wkern.window_overflow(state)

    def hit_positions(self, matches: np.ndarray) -> List[Tuple[int, int]]:
        """(t, b) positions with ≥ 1 match."""
        t_idx, b_idx = np.nonzero(matches)
        return list(zip(t_idx.tolist(), b_idx.tolist()))

    # ------------------------------------------------------------------
    def arena_tables(self) -> tecs_arena.ArenaTables:
        """Static predecessor tables driving the device tECS arena."""
        tbl = getattr(self, "_arena_tables", None)
        if tbl is None:
            tbl = tecs_arena.tables_from_symbolic(self.symbolic)
            self._arena_tables = tbl
        return tbl

    def run_enumerate(self, streams: Sequence[Sequence[Event]],
                      start_pos: int = 0, arena_capacity: int = 1 << 15,
                      strategy: Optional[str] = None
                      ) -> Tuple[np.ndarray,
                                 Dict[Tuple[int, int], List[ComplexEvent]]]:
        """Counting pipeline, device arena and enumeration in one call.

        The predicates, the counting scan and the arena run on the engine's
        device (:func:`repro_torch.vector.tecs_arena.run_enumerate`); the
        host fetches the arena and walks Algorithm 2 (output-linear delay,
        no event replay).  ``strategy=None`` enumerates under the query's
        own compiled semantics; an explicit strategy post-filters, and only
        plain-ALL engines accept one.

        Returns ``(counts (T, B) int64, matches)`` with ``matches`` mapping
        each hit ``(t, b)`` to its complex events.
        """
        counts, res = tecs_arena.run_enumerate(
            self, streams, start_pos=start_pos,
            arena_capacity=arena_capacity, strategy=strategy)
        return counts[:, :, 0], {(t, b): v for (t, b, _q), v in res.items()}

    def partitioned_streaming(self, key_attrs: Sequence[str],
                              chunk_len: int, num_lanes: int, **kw):
        """PARTITION BY over this query's tables: a
        :class:`repro_torch.vector.partitioned.PartitionedStreamingEngine`
        that routes raw interleaved chunks to ``num_lanes`` substream lanes
        on the device."""
        from .partitioned import PartitionedStreamingEngine
        return PartitionedStreamingEngine(self, key_attrs, chunk_len,
                                          num_lanes, **kw)
