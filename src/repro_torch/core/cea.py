"""Complex Event Automata (paper §4, Appendix A).

Pipeline:

    CEL formula ──compile──▶ VCEA (variable-marking transitions, Appendix A)
               ──project──▶ CEA  (•/◦ marking actions, single initial state)
               ──on-the-fly subset construction──▶ I/O-deterministic CEA view

The determinization is performed lazily while the stream is processed and its
results are cached (``(det-state, bit-vector) → (q•, q◦)``), exactly as §5.4
describes.  Det states are frozensets of CEA states; the cache is the paper's
"fast-index".
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from . import cel as C
from .predicates import (AtomRegistry, BAnd, BitExpr, BLit, BTrue, PredExpr,
                         PTrue, type_predicate, PAtom)

# ---------------------------------------------------------------------------
# VCEA — valuation CEA (Appendix A)
# ---------------------------------------------------------------------------

Label = FrozenSet[str]


@dataclass
class VTransition:
    src: int
    pred: BitExpr
    label: Label  # ∅ ⇒ non-marking
    dst: int


@dataclass
class VCEA:
    num_states: int
    transitions: List[VTransition]
    initial: Set[int]
    finals: Set[int]


class _Builder:
    """Fresh-state allocator shared across the inductive construction."""

    def __init__(self, registry: AtomRegistry):
        self.registry = registry
        self.count = 0

    def fresh(self) -> int:
        s = self.count
        self.count += 1
        return s


def _compile(phi: C.CEL, b: _Builder) -> VCEA:
    if isinstance(phi, C.EventType):
        q1, q2 = b.fresh(), b.fresh()
        bit = b.registry.register(type_predicate(phi.name))
        tr = VTransition(q1, BLit(bit), frozenset({phi.name}), q2)
        return VCEA(b.count, [tr], {q1}, {q2})

    if isinstance(phi, C.As):
        a = _compile(phi.child, b)
        out = []
        for t in a.transitions:
            if t.label:
                out.append(VTransition(t.src, t.pred, t.label | {phi.var}, t.dst))
            else:
                out.append(t)
        return VCEA(b.count, out, a.initial, a.finals)

    if isinstance(phi, C.Filter):
        a = _compile(phi.child, b)
        pbit = b.registry.lower(phi.pred)
        out = []
        for t in a.transitions:
            if phi.var in t.label:
                out.append(VTransition(t.src, BAnd(t.pred, pbit), t.label, t.dst))
            else:
                out.append(t)
        return VCEA(b.count, out, a.initial, a.finals)

    if isinstance(phi, C.Or):
        a1 = _compile(phi.left, b)
        a2 = _compile(phi.right, b)
        return VCEA(b.count, a1.transitions + a2.transitions,
                    a1.initial | a2.initial, a1.finals | a2.finals)

    if isinstance(phi, C.Seq):
        a1 = _compile(phi.left, b)
        a2 = _compile(phi.right, b)
        out = a1.transitions + a2.transitions
        # skip self-loops on the initial states of the second operand
        for p in a2.initial:
            out.append(VTransition(p, BTrue(), frozenset(), p))
        # bridge: transitions into F1 are copied to go into I2
        for t in a1.transitions:
            if t.dst in a1.finals:
                for q in a2.initial:
                    out.append(VTransition(t.src, t.pred, t.label, q))
        return VCEA(b.count, out, a1.initial, a2.finals)

    if isinstance(phi, C.Plus):
        a = _compile(phi.child, b)
        q = b.fresh()
        out = list(a.transitions)
        # finishing one iteration lands on the junction q ...
        for t in a.transitions:
            if t.dst in a.finals:
                out.append(VTransition(t.src, t.pred, t.label, q))
        # ... from which the next iteration can start ...
        for t in a.transitions:
            if t.src in a.initial:
                out.append(VTransition(q, t.pred, t.label, t.dst))
        # ... and a one-transition iteration goes junction → junction (needed
        # from the third iteration onward when the body is a single step).
        for t in a.transitions:
            if t.src in a.initial and t.dst in a.finals:
                out.append(VTransition(q, t.pred, t.label, q))
        # Skip-till-any-match between iterations: φ+ ≡ φ OR (φ ; φ+), and the
        # ';' construction introduces a TRUE self-loop before the second
        # operand.  The junction state therefore carries the same self-loop.
        out.append(VTransition(q, BTrue(), frozenset(), q))
        return VCEA(b.count, out, a.initial, a.finals)

    if isinstance(phi, C.Proj):
        a = _compile(phi.child, b)
        out = [VTransition(t.src, t.pred, frozenset(t.label & phi.keep), t.dst)
               for t in a.transitions]
        return VCEA(b.count, out, a.initial, a.finals)

    raise TypeError(f"unknown CEL node {phi!r}")


# ---------------------------------------------------------------------------
# CEA — single initial state, •/◦ actions (paper §4)
# ---------------------------------------------------------------------------

MARK = True
UNMARK = False


@dataclass
class Transition:
    src: int
    pred: BitExpr
    mark: bool
    dst: int


@dataclass
class CEA:
    """``A = (Q, Δ, q0, F)``; q0 has no incoming transitions (paper §4)."""

    num_states: int
    transitions: List[Transition]
    q0: int
    finals: Set[int]
    registry: AtomRegistry

    # adjacency: state -> list of transitions
    _adj: Dict[int, List[Transition]] = field(default_factory=dict)

    def __post_init__(self):
        self._adj = {}
        for t in self.transitions:
            self._adj.setdefault(t.src, []).append(t)

    def out(self, state: int) -> List[Transition]:
        return self._adj.get(state, [])


def compile_cel(phi: C.CEL, registry: Optional[AtomRegistry] = None) -> CEA:
    """CEL → CEA (Theorem 1); linear size in ``|φ|``."""
    registry = registry or AtomRegistry()
    b = _Builder(registry)
    v = _compile(phi, b)

    # Single fresh initial state q0 with copies of all initial out-transitions
    # (Appendix A); q0 has no incoming transitions.
    q0 = b.fresh()
    transitions: List[Transition] = []
    for t in v.transitions:
        transitions.append(Transition(t.src, t.pred, bool(t.label), t.dst))
        if t.src in v.initial:
            transitions.append(Transition(q0, t.pred, bool(t.label), t.dst))
    finals = set(v.finals)
    if v.initial & v.finals:
        # ε-accepting formulas cannot arise from this grammar (every formula
        # consumes ≥ 1 event), but guard anyway.
        finals.add(q0)
    return CEA(b.count, transitions, q0, finals, registry)


# ---------------------------------------------------------------------------
# On-the-fly I/O-determinization (paper §4 end + §5.4)
# ---------------------------------------------------------------------------

DetState = int  # interned id of a frozenset of CEA states


class DetCEA:
    """I/O-deterministic view of a CEA via cached subset construction.

    For det state ``P`` and bit-vector ``v``::

        q• = {q | ∃p∈P, (p ─pred/•→ q) ∈ Δ, v ⊨ pred}
        q◦ = {q | ∃p∈P, (p ─pred/◦→ q) ∈ Δ, v ⊨ pred}

    Both successors are themselves det states; the pair is memoized under
    ``(P, v)``.  An event may trigger both a marking and a non-marking
    transition — but never two of the same action — which is exactly the
    I/O-determinism condition.
    """

    def __init__(self, cea: CEA):
        self.cea = cea
        self._interned: Dict[FrozenSet[int], int] = {}
        self._sets: List[FrozenSet[int]] = []
        self._is_final: List[bool] = []
        self._cache: Dict[Tuple[int, int], Tuple[Optional[int], Optional[int]]] = {}
        self.initial = self._intern(frozenset({cea.q0}))

    # -- interning ----------------------------------------------------------
    def _intern(self, states: FrozenSet[int]) -> int:
        sid = self._interned.get(states)
        if sid is None:
            sid = len(self._sets)
            self._interned[states] = sid
            self._sets.append(states)
            self._is_final.append(bool(states & self.cea.finals))
        return sid

    def is_final(self, det_state: int) -> bool:
        return self._is_final[det_state]

    def states_of(self, det_state: int) -> FrozenSet[int]:
        return self._sets[det_state]

    @property
    def num_det_states(self) -> int:
        return len(self._sets)

    # -- the Δ(p, t, m) oracle used by Algorithm 1 ---------------------------
    def step(self, det_state: int, bitvec: int
             ) -> Tuple[Optional[int], Optional[int]]:
        """Returns ``(Δ(p, v, •), Δ(p, v, ◦))`` — ``None`` encodes the dead state."""
        key = (det_state, bitvec)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        marked: Set[int] = set()
        unmarked: Set[int] = set()
        for p in self._sets[det_state]:
            for t in self.cea.out(p):
                if t.pred.evaluate(bitvec):
                    (marked if t.mark else unmarked).add(t.dst)
        q_mark = self._intern(frozenset(marked)) if marked else None
        q_unmark = self._intern(frozenset(unmarked)) if unmarked else None
        result = (q_mark, q_unmark)
        self._cache[key] = result
        return result
