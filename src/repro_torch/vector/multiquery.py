"""Packed multi-query evaluation: many standing queries over one stream.

Production CER deployments run many queries over the same streams.  The
packed engine evaluates q of them in one scan:

* all queries share one :class:`~repro_torch.core.predicates.AtomRegistry`,
  so one bit-vector per event serves every query, folded into one *joint*
  symbol class (distinct joint behaviour of the queries' own classes);
* the packed transition matrix is block-diagonal,
  ``M̂[c] = diag(M₁[c], …, M_q[c])`` with ``Ŝ = Σ S_i`` states;
* one ``(B, W, Ŝ)`` ring evaluates every query, and per-query match counts
  come from per-query final-state masks.

Counts are exact per query: the blocks do not interact.

A :class:`Packing` describes the pack: per-query state offsets and sizes,
the joint-class tables, and optional *dead padding* of every
query-dependent dimension (states, query slots, classes, predicate bits) up
to bucket sizes.  Padded states receive no transitions, seeds or finals
mass (:func:`check_packing_invariants`).  Tables, specs and fingerprints are
byte-identical to the reference package's, so packed snapshots restore
across the two packages.

On CUDA, :meth:`MultiQueryEngine.pipeline` launches the fused-scan kernel
(or, with ``impl="unfused"``, the bit-vector and packed-scan kernels), and
:meth:`~MultiQueryEngine.classify` / :meth:`~MultiQueryEngine.scan` are the
unfused path's two halves.
"""
from __future__ import annotations

import hashlib
import warnings
from dataclasses import dataclass, field, replace
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.predicates import AtomRegistry
from ..core.query import CompiledQuery, compile_query, resolve_semantics
from ..kernels import ops
from ..kernels import window as wkern
from . import tecs_arena
from .encoder import EventEncoder
from .engine import _fallback_base, encode_windowed, resolve_device
from .symbolic import SymbolicCEA, compile_symbolic

#: a padding target: an explicit size, or a policy mapping the live size to
#: the padded size (for instance a power-of-two bucket policy)
PadSpec = Optional[Union[int, Callable[[int], int]]]


def _host(a) -> Optional[np.ndarray]:
    """A table as a host numpy array (its own dtype), or None."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


@dataclass
class PackedTables:
    """The packed automaton's tables (torch tensors on one device)."""

    m_all: torch.Tensor         # (C_pad, Ŝ_pad, Ŝ_pad) f32
    finals: torch.Tensor        # (Q_pad, Ŝ_pad) f32, one row per query slot
    class_of: torch.Tensor      # (2^k_pad,) int32
    class_ind: torch.Tensor     # (≥2^k_pad, C_pad) f32 one-hot class_of
    init_mask: torch.Tensor     # (Ŝ_pad,) f32, 1 at each query's initial
    offsets: List[int]          # block start per query
    sizes: List[int]
    reps: np.ndarray            # (C,) representative bit-vector per class
    # per-query LAST flag and CONSUME BY ANY state-clear rows over the
    # query's own block; None when every packed query is trivial, which
    # keeps plain packs' fingerprints those of the format without them
    latest_q: Optional[torch.Tensor] = None    # (Q_pad,) f32 | None
    consume_sq: Optional[torch.Tensor] = None  # (Q_pad, Ŝ_pad) f32 | None

    def to(self, device) -> "PackedTables":
        """A copy with every tensor on ``device``."""
        def mv(t):
            return None if t is None else t.to(device)
        return replace(self, m_all=mv(self.m_all), finals=mv(self.finals),
                       class_of=mv(self.class_of),
                       class_ind=mv(self.class_ind),
                       init_mask=mv(self.init_mask),
                       latest_q=mv(self.latest_q),
                       consume_sq=mv(self.consume_sq))


class PackingInvariantError(ValueError):
    """A packing violates the dead-padding / block-diagonal contract."""


@dataclass
class Packing:
    """Descriptor of a packed multi-query automaton.

    Everything an engine (or a state migration) needs to interpret a
    block-diagonal state space: which query owns which state range
    (``offsets``/``sizes``, the de-pack map), the joint-class tables, and
    the padded *bucket* dimensions the device arrays are allocated at.
    ``qids`` are caller-chosen stable identifiers: a migration between two
    packings matches queries by qid, not by slot position.
    """

    qids: Tuple[str, ...]
    queries: Tuple[str, ...]             # CEQL text, aligned with qids
    compiled: List[CompiledQuery]
    symbolics: List[SymbolicCEA]
    encoder: EventEncoder
    tables: PackedTables                 # host (CPU) tensors
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    num_states: int                      # live Ŝ = Σ sizes
    padded_states: int
    num_queries: int
    padded_queries: int
    num_classes: int                     # live joint classes C
    padded_classes: int
    num_bits: int                        # k (shared registry width)
    padded_bits: int
    strategies: Tuple[str, ...] = ()     # per-query SELECT strategy
    consumes: Tuple[bool, ...] = ()      # per-query CONSUME BY ANY flag
    _fingerprint: Optional[str] = field(default=None, repr=False)

    # -- de-pack maps ---------------------------------------------------
    def slot_of(self, qid: str) -> int:
        return self.qids.index(qid)

    def state_range(self, slot: int) -> Tuple[int, int]:
        """``[start, end)`` packed-state range owned by query ``slot``."""
        return self.offsets[slot], self.offsets[slot] + self.sizes[slot]

    def query_of_state(self) -> np.ndarray:
        """(Ŝ_pad,) int32 de-pack map: owning query slot, -1 for padding."""
        q = np.full(self.padded_states, -1, np.int32)
        for qi, (off, sz) in enumerate(zip(self.offsets, self.sizes)):
            q[off:off + sz] = qi
        return q

    # -- manifests ------------------------------------------------------
    def spec(self) -> dict:
        """JSON-able packing spec recorded in snapshot manifests; a
        ``restore(migrate_packing=True)`` migrates state between two."""
        return {
            "qids": list(self.qids),
            "offsets": list(map(int, self.offsets)),
            "sizes": list(map(int, self.sizes)),
            "num_states": int(self.num_states),
            "padded_states": int(self.padded_states),
            "num_queries": int(self.num_queries),
            "padded_queries": int(self.padded_queries),
            "strategies": list(self.strategies),
            "consumes": [bool(c) for c in self.consumes],
        }

    def _hash_tables(self, h) -> None:
        enc = self.encoder
        h.update(repr((enc.attrs, enc.specs,
                       sorted((a, sorted(v.items()))
                              for a, v in enc.vocab.items()))).encode())
        t = self.tables
        for arr in (t.m_all, t.finals, t.class_of, t.init_mask):
            a = _host(arr)
            h.update(str((a.shape, str(a.dtype))).encode())
            h.update(a.tobytes())
        # LAST shares MAX's m_all and consuming queries the non-consuming
        # tables, so the semantic operands are hashed too, only when present
        if t.latest_q is not None or t.consume_sq is not None:
            h.update(b"semantics")
            for arr in (t.latest_q, t.consume_sq):
                if arr is None:
                    h.update(b"none")
                else:
                    a = _host(arr)
                    h.update(str((a.shape, str(a.dtype))).encode())
                    h.update(a.tobytes())

    @property
    def table_fingerprint(self) -> str:
        """Digest of the packed automaton and encoder layout only (no
        qids): equal digests mean bit-identical device behaviour whatever
        the queries are named."""
        h = hashlib.sha256()
        self._hash_tables(h)
        return h.hexdigest()

    @property
    def fingerprint(self) -> str:
        """:attr:`table_fingerprint` extended with the ``qids``: equal
        digests mean interchangeable packed state (same device behaviour
        and the same membership)."""
        if self._fingerprint is None:
            h = hashlib.sha256()
            h.update(repr(self.qids).encode())
            self._hash_tables(h)
            object.__setattr__(self, "_fingerprint", h.hexdigest())
        return self._fingerprint


def _resolve_pad(pad: PadSpec, live: int, what: str) -> int:
    if pad is None:
        return live
    n = pad(live) if callable(pad) else int(pad)
    if n < live:
        raise ValueError(f"pad_{what}={n} is below the live size {live}")
    return n


def build_packing(queries: Sequence[str], *,
                  qids: Optional[Sequence[str]] = None,
                  pad_states: PadSpec = None,
                  pad_queries: PadSpec = None,
                  pad_classes: PadSpec = None,
                  pad_bits: PadSpec = None) -> Packing:
    """Compile ``queries`` against one shared registry into a
    :class:`Packing` with host tables.

    ``pad_*`` grow the corresponding device-array dimension to a bucket
    size (an int, or a policy callable ``live → padded``).  All padding is
    dead: padded states get no transitions, seeds or finals, padded query
    slots have all-zero finals rows, padded classes all-zero matrices, and
    padded predicate bits can never be set (:func:`check_packing_invariants`).
    """
    queries = list(queries)
    if not queries:
        raise ValueError("a packing needs at least one query")
    if qids is None:
        qids = tuple(f"q{i}" for i in range(len(queries)))
    qids = tuple(qids)
    if len(qids) != len(queries) or len(set(qids)) != len(qids):
        raise ValueError("qids must be unique and aligned with queries")

    registry = AtomRegistry()   # shared across the queries
    compiled = [compile_query(q, registry) for q in queries]
    encoder = EventEncoder.from_registry(registry)
    # an unsupported strategy / CONSUME combination raises here, before any
    # device table exists
    sems = [resolve_semantics(c.query) for c in compiled]
    symbolics = [compile_symbolic(c.cea, strategy=s.construction)
                 for c, s in zip(compiled, sems)]

    # every symbolic shares num_bits (one registry) but has its own class
    # partition: combine them into joint classes
    k = symbolics[0].num_bits
    n_vec = 1 << k
    joint = np.stack([s.class_of for s in symbolics])        # (Q, 2^k)
    _, class_of = np.unique(joint, axis=1, return_inverse=True)
    class_of = class_of.reshape(-1)
    n_classes = int(class_of.max()) + 1
    reps = np.zeros(n_classes, dtype=np.int64)
    for v in range(n_vec - 1, -1, -1):
        reps[class_of[v]] = v

    sizes = [s.num_states for s in symbolics]
    S_hat = sum(sizes)
    offsets = list(np.cumsum([0] + sizes[:-1]))

    kp = _resolve_pad(pad_bits, k, "bits")
    Sp = _resolve_pad(pad_states, S_hat, "states")
    Qp = _resolve_pad(pad_queries, len(sizes), "queries")
    Cp = _resolve_pad(pad_classes, n_classes, "classes")

    class_of_p = np.zeros(1 << kp, np.int32)
    class_of_p[:n_vec] = class_of.astype(np.int32)

    m_all = np.zeros((Cp, Sp, Sp), np.float32)
    finals = np.zeros((Qp, Sp), np.float32)
    init_mask = np.zeros((Sp,), np.float32)
    latest = np.zeros((Qp,), np.float32)
    consume = np.zeros((Qp, Sp), np.float32)
    for qi, sym in enumerate(symbolics):
        off = offsets[qi]
        Mq = sym.transition_matrices()                       # (Cq, S, S)
        for c in range(n_classes):
            cq = sym.class_of[reps[c]]
            m_all[c, off:off + sizes[qi], off:off + sizes[qi]] = Mq[cq]
        finals[qi, off:off + sizes[qi]] = sym.finals.astype(np.float32)
        init_mask[off + sym.initial] = 1.0
        if sems[qi].latest:
            latest[qi] = 1.0
        if sems[qi].consume:
            # a consuming query clears its own block only
            consume[qi, off:off + sizes[qi]] = 1.0

    tables = PackedTables(
        m_all=torch.from_numpy(m_all), finals=torch.from_numpy(finals),
        class_of=torch.from_numpy(class_of_p),
        class_ind=ops.class_indicator(class_of_p, Cp),
        init_mask=torch.from_numpy(init_mask),
        offsets=[int(o) for o in offsets], sizes=list(sizes), reps=reps,
        latest_q=torch.from_numpy(latest) if latest.any() else None,
        consume_sq=torch.from_numpy(consume) if consume.any() else None)
    return Packing(
        qids=qids, queries=tuple(queries), compiled=compiled,
        symbolics=symbolics, encoder=encoder, tables=tables,
        offsets=tuple(int(o) for o in offsets), sizes=tuple(sizes),
        num_states=S_hat, padded_states=Sp,
        num_queries=len(sizes), padded_queries=Qp,
        num_classes=n_classes, padded_classes=Cp,
        num_bits=k, padded_bits=kp,
        strategies=tuple(c.query.strategy for c in compiled),
        consumes=tuple(bool(c.query.consume_on_match) for c in compiled))


def check_packing_invariants(packing: Packing) -> None:
    """Verify the dead-padding / block-diagonal contract.

    Raises :class:`PackingInvariantError` when any of these fail:

    1. padded dimensions are dead: no transitions into or out of states
       past ``num_states``, no seeds or finals mass there or on padded
       query slots, all-zero matrices for padded classes, padded
       ``class_of`` entries mapping to class 0;
    2. the per-query ``[offset, offset + size)`` ranges tile
       ``[0, num_states)`` without gaps or overlaps;
    3. joint classes agree with each query's own classifier, and the block
       of ``m_all`` a query owns is its own transition matrix;
    4. the semantic operands agree with the per-query strategies.
    """
    t = packing.tables
    m = _host(t.m_all)
    fin = _host(t.finals)
    im = _host(t.init_mask)
    cof = _host(t.class_of)
    S, Sp = packing.num_states, packing.padded_states
    Q, Qp = packing.num_queries, packing.padded_queries
    C, Cp = packing.num_classes, packing.padded_classes
    n_vec = 1 << packing.num_bits

    def fail(msg: str):
        raise PackingInvariantError(f"packing invariant violated: {msg}")

    if m.shape != (Cp, Sp, Sp) or fin.shape != (Qp, Sp) or im.shape != (Sp,):
        fail(f"table shapes {m.shape}/{fin.shape}/{im.shape} do not match "
             f"the declared geometry (C_pad={Cp}, S_pad={Sp}, Q_pad={Qp})")
    # 1. dead padding
    if m[:, S:, :].any() or m[:, :, S:].any():
        fail("padded states have transitions (rows/cols beyond Ŝ not zero)")
    if m[C:].any():
        fail("padded classes have non-zero transition matrices")
    if im[S:].any():
        fail("padded states are seeded by init_mask")
    if fin[:, S:].any():
        fail("padded states carry finals mass")
    if fin[Q:].any():
        fail("padded query slots carry finals mass")
    if cof[n_vec:].any():
        fail("padded class_of entries must map to class 0")
    if cof[:n_vec].min() < 0 or cof[:n_vec].max() >= C:
        fail("class_of values outside [0, num_classes)")
    # 2. the de-pack maps partition [0, Ŝ)
    cursor = 0
    for qi, (off, sz) in enumerate(zip(packing.offsets, packing.sizes)):
        if off != cursor:
            fail(f"query block {qi} starts at {off}, expected {cursor} — "
                 "offsets must tile Ŝ contiguously")
        if sz != packing.symbolics[qi].num_states:
            fail(f"query block {qi} size {sz} != its automaton's "
                 f"{packing.symbolics[qi].num_states} states")
        cursor += sz
    if cursor != S:
        fail(f"blocks cover {cursor} states, packing declares Ŝ={S}")
    if im[:S].sum() != Q:
        fail("init_mask must seed exactly one state per live query")
    # 3. joint classes agree with each query's own classifier
    reps = t.reps
    for qi, sym in enumerate(packing.symbolics):
        own = sym.class_of
        if not np.array_equal(own[:n_vec],
                              own[reps[cof[:n_vec].astype(np.int64)]]):
            fail(f"query {qi}: some bit-vector disagrees with its joint "
                 "class representative under the query's own classifier")
        off, sz = packing.offsets[qi], packing.sizes[qi]
        Mq = sym.transition_matrices()
        for c in range(C):
            cq = int(own[reps[c]])
            if not np.array_equal(m[c, off:off + sz, off:off + sz], Mq[cq]):
                fail(f"query {qi}: m_all block for joint class {c} != the "
                     f"query's own matrix for its class {cq}")
        if not np.array_equal(fin[qi, off:off + sz],
                              sym.finals.astype(np.float32)):
            fail(f"query {qi}: finals row disagrees with its automaton")
        if im[off + sym.initial] != 1.0:
            fail(f"query {qi}: initial state not seeded")
    # 4. semantic operands agree with the declared per-query semantics
    strategies = packing.strategies or ("ALL",) * Q
    consumes = packing.consumes or (False,) * Q
    want_latest = [qi for qi in range(Q) if strategies[qi] == "LAST"]
    if t.latest_q is None:
        if want_latest:
            fail(f"LAST queries {want_latest} but no latest_q operand — "
                 "their counts would come out under MAX semantics")
    else:
        la = _host(t.latest_q)
        if la.shape != (Qp,):
            fail(f"latest_q shape {la.shape} != (Q_pad={Qp},)")
        exp = np.zeros(Qp, np.float32)
        exp[want_latest] = 1.0
        if not np.array_equal(la, exp):
            fail("latest_q flags disagree with the per-query strategies")
    want_consume = [qi for qi in range(Q) if consumes[qi]]
    if t.consume_sq is None:
        if want_consume:
            fail(f"CONSUME BY ANY queries {want_consume} but no consume_sq "
                 "operand — their matches would never clear the ring")
    else:
        co = _host(t.consume_sq)
        if co.shape != (Qp, Sp):
            fail(f"consume_sq shape {co.shape} != (Q_pad={Qp}, S_pad={Sp})")
        exp = np.zeros((Qp, Sp), np.float32)
        for qi in want_consume:
            off, sz = packing.offsets[qi], packing.sizes[qi]
            exp[qi, off:off + sz] = 1.0
        if not np.array_equal(co, exp):
            fail("consume_sq rows must cover exactly each consuming "
                 "query's own state block")


def resolve_query_window(spec, *, epsilon: Optional[int] = None,
                         max_window_events: Optional[int] = None
                         ) -> wkern.DeviceWindow:
    """Resolve one query's window, with the kwargs as *defaults*:
    ``epsilon`` applies only to clause-free queries, ``max_window_events``
    only to time windows; each query's own clause wins."""
    kind = getattr(spec, "kind", "none") if spec is not None else "none"
    with warnings.catch_warnings():
        # the clause-free shim warns per resolution; once is plenty
        warnings.filterwarnings("ignore",
                                message=".*epsilon= for a query without.*")
        return wkern.resolve_window(
            spec,
            epsilon=epsilon if kind == "none" else None,
            max_window_events=(max_window_events if kind == "time"
                               else None))


class MultiQueryEngine:
    """Evaluate several CEQL queries over the same B streams in one scan.

    Every packed query must declare the same window.  ``device=None`` runs
    on CUDA (``RuntimeError`` without one); pass ``device="cpu"`` for the
    plain PyTorch version.  ``impl`` routes the pipeline (``"fused"``,
    ``"unfused"`` or ``"ref"``, as :func:`repro_torch.kernels.ops.
    cer_pipeline`).
    """

    def __init__(self, queries: Sequence[str],
                 epsilon: Optional[int] = None, impl: Optional[str] = None,
                 arena_impl: str = "block",
                 max_window_events: Optional[int] = None, device=None):
        self._init_from_packing(
            build_packing(queries), epsilon=epsilon, impl=impl,
            arena_impl=arena_impl, max_window_events=max_window_events,
            device=device, strict_windows=True)

    @classmethod
    def from_packing(cls, packing: Packing, epsilon: Optional[int] = None,
                     impl: Optional[str] = None, arena_impl: str = "block",
                     max_window_events: Optional[int] = None, device=None
                     ) -> "MultiQueryEngine":
        """An engine over a prebuilt (possibly padded) packing.  Windows
        must agree once resolved (two WITHIN clauses that resolve alike may
        pack)."""
        self = cls.__new__(cls)
        self._init_from_packing(
            packing, epsilon=epsilon, impl=impl, arena_impl=arena_impl,
            max_window_events=max_window_events, device=device,
            strict_windows=False)
        return self

    def _init_from_packing(self, packing: Packing, *, epsilon, impl,
                           arena_impl, max_window_events, device,
                           strict_windows: bool):
        self.device = resolve_device(device)
        self.packing = packing
        self.compiled = list(packing.compiled)
        self.encoder = packing.encoder
        self.symbolics = list(packing.symbolics)
        # one scan = one ring = one window
        specs = [c.query.window for c in self.compiled]
        if strict_windows:
            keys = {(w.kind, w.size, w.time_attr) for w in specs}
            if len(keys) > 1:
                raise ValueError(
                    "packed queries share one scan and therefore one "
                    f"window; got {len(keys)} distinct WITHIN clauses: "
                    f"{sorted(keys, key=repr)} — pack queries with "
                    "different windows into separate engines")
            self.window = wkern.resolve_window(
                specs[0], epsilon=epsilon,
                max_window_events=max_window_events)
        else:
            windows = {resolve_query_window(
                s, epsilon=epsilon, max_window_events=max_window_events)
                for s in specs}
            if len(windows) > 1:
                raise ValueError(
                    "packed queries share one scan and therefore one "
                    f"window; the packing resolves {len(windows)} distinct "
                    "device windows — pack them into separate engines")
            self.window = windows.pop()
        self.epsilon = self.window.epsilon
        self.ring = self.window.ring
        self.impl = "fused" if impl is None else impl
        if self.impl not in ops.IMPLS:
            raise ValueError(f"impl must be one of {ops.IMPLS}, got "
                             f"{self.impl!r}")
        self.arena_impl = tecs_arena.check_arena_impl(arena_impl)
        self.tables = packing.tables.to(self.device)
        sems = [c.semantics for c in self.compiled]
        self.strategies = tuple(c.query.strategy for c in self.compiled)
        self.consumes = tuple(
            bool(c.query.consume_on_match) for c in self.compiled)
        self.native_semantics = any(
            s.construction != "ALL" or s.latest or s.consume for s in sems)

    # ------------------------------------------------------------------
    @property
    def packed_states(self) -> int:
        return int(self.tables.m_all.shape[1])

    def init_state(self, batch: int):
        """Fresh scan state on the engine's device."""
        return wkern.init_state(self.window, batch, self.packed_states,
                                device=self.device)

    def classify(self, attrs: torch.Tensor) -> torch.Tensor:
        """(T, B, A) attributes → (T, B) int32 joint-class ids (the
        bit-vector kernel on CUDA, then the ``class_of`` gather)."""
        T, B, A = attrs.shape
        bits = ops.bitvector(attrs.reshape(T * B, A), self.encoder.specs)
        return self.tables.class_of[bits.long()].reshape(T, B)

    def scan(self, class_ids: torch.Tensor, state: torch.Tensor,
             start_pos: Union[int, torch.Tensor] = 0
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(T, B) class ids × (B, W, Ŝ) state → (matches (T, B, Q),
        state'): the packed scan kernel, every query's initial state seeded
        at each step.  Count windows and ANY semantics only; time windows,
        LAST and CONSUME BY ANY evaluate through :meth:`pipeline`."""
        wkern.require_count_scan(self.window)
        if self.tables.latest_q is not None or \
                self.tables.consume_sq is not None:
            raise ValueError(
                "scan() cannot honor LAST / CONSUME BY ANY semantics "
                f"(packed strategies {self.strategies!r}); use pipeline()")
        t = self.tables
        return ops.cea_scan_multi(class_ids, t.m_all, t.finals, state,
                                  init_mask=t.init_mask,
                                  epsilon=self.epsilon, start_pos=start_pos)

    def pipeline(self, attrs: torch.Tensor, state,
                 start_pos: Union[int, torch.Tensor] = 0,
                 event_ts: Optional[torch.Tensor] = None):
        """(T, B, A) attrs → (matches (T, B, Q), state')."""
        t = self.tables
        return ops.cer_pipeline(
            attrs, self.encoder.specs, t.class_of, t.class_ind, t.m_all,
            t.finals, state, init_mask=t.init_mask, window=self.window,
            event_ts=event_ts, start_pos=start_pos, impl=self.impl,
            latest_q=t.latest_q, consume_sq=t.consume_sq)

    def encode_ts(self, streams, base_pos: Optional[int] = 0):
        """→ (attrs (T, B, A), event_ts (T, B) | None) per the window."""
        return encode_windowed(self.encoder, self.window, streams,
                               self.device, base_pos=base_pos)

    def run(self, streams, state=None,
            start_pos: Union[int, torch.Tensor] = 0):
        """Host → device → host: (match counts (T, B, Q) int64, state)."""
        attrs, ts = self.encode_ts(
            streams, base_pos=_fallback_base(self.window, start_pos))
        if state is None:
            state = self.init_state(attrs.shape[1])
        matches, state = self.pipeline(attrs, state, start_pos=start_pos,
                                       event_ts=ts)
        return matches.cpu().numpy().astype(np.int64), state

    # ------------------------------------------------------------------
    # device tECS arena over the packed automaton
    # ------------------------------------------------------------------
    def arena_tables(self) -> tecs_arena.ArenaTables:
        """Predecessor tables of the block-diagonal packed det CEA."""
        tbl = getattr(self, "_arena_tables", None)
        if tbl is None:
            tbl = tecs_arena.tables_from_packed(
                self.symbolics, self.tables.offsets,
                _host(self.tables.class_of), self.tables.reps)
            self._arena_tables = tbl
        return tbl

    def run_enumerate(self, streams, start_pos: int = 0,
                      arena_capacity: int = 1 << 15,
                      strategy: Optional[str] = None):
        """Packed-query enumeration from the device arena (no event
        replay).  ``strategy=None`` enumerates each query under its own
        compiled semantics.  Returns ``(counts (T, B, Q) int64, matches)``
        with ``matches`` mapping each hit ``(t, b, q)`` to its complex
        events."""
        return tecs_arena.run_enumerate(
            self, streams, start_pos=start_pos,
            arena_capacity=arena_capacity, strategy=strategy)
