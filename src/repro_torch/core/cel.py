"""Complex Event Logic (CEL) abstract syntax and direct semantics (paper §3).

The grammar (paper §3):

    φ := R | φ AS X | φ FILTER X[P] | φ OR φ | φ ; φ | φ+ | π_L(φ)

``semantics(φ, stream)`` implements Table 2 *directly* (sets of valuations) and
is used as the brute-force oracle against which the automaton engine is tested.
It is exponential and only suitable for tiny streams.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import FrozenSet, Iterable, List, Sequence, Set, Tuple

from .events import Event, Valuation
from .predicates import PredExpr


class CEL:
    """Base class for CEL formulas."""

    # convenience combinators -------------------------------------------------
    def seq(self, other: "CEL") -> "CEL":
        return Seq(self, other)

    def or_(self, other: "CEL") -> "CEL":
        return Or(self, other)

    def plus(self) -> "CEL":
        return Plus(self)

    def as_(self, var: str) -> "CEL":
        return As(self, var)

    def filter(self, var: str, pred: PredExpr) -> "CEL":
        return Filter(self, var, pred)

    def variables(self) -> Set[str]:
        raise NotImplementedError


@dataclass(frozen=True)
class EventType(CEL):
    name: str

    def variables(self):
        return {self.name}

    def __str__(self):
        return self.name


@dataclass(frozen=True)
class As(CEL):
    child: CEL
    var: str

    def variables(self):
        return self.child.variables() | {self.var}

    def __str__(self):
        return f"({self.child} AS {self.var})"


@dataclass(frozen=True)
class Filter(CEL):
    child: CEL
    var: str
    pred: PredExpr

    def variables(self):
        return self.child.variables()

    def __str__(self):
        return f"({self.child} FILTER {self.var}[{self.pred}])"


@dataclass(frozen=True)
class Or(CEL):
    left: CEL
    right: CEL

    def variables(self):
        return self.left.variables() | self.right.variables()

    def __str__(self):
        return f"({self.left} OR {self.right})"


@dataclass(frozen=True)
class Seq(CEL):
    left: CEL
    right: CEL

    def variables(self):
        return self.left.variables() | self.right.variables()

    def __str__(self):
        return f"({self.left} ; {self.right})"


@dataclass(frozen=True)
class Plus(CEL):
    child: CEL

    def variables(self):
        return self.child.variables()

    def __str__(self):
        return f"({self.child})+"


@dataclass(frozen=True)
class Proj(CEL):
    child: CEL
    keep: FrozenSet[str]

    def variables(self):
        return set(self.keep)

    def __str__(self):
        return f"π_{{{','.join(sorted(self.keep))}}}({self.child})"


# ---------------------------------------------------------------------------
# Direct (oracle) semantics — Table 2 of the paper.
# Valuations are represented as (start, end, {var: frozenset(positions)}).
# ---------------------------------------------------------------------------

_Val = Tuple[int, int, Tuple[Tuple[str, FrozenSet[int]], ...]]


def _mk(mapping: dict) -> Tuple[Tuple[str, FrozenSet[int]], ...]:
    return tuple(sorted((k, frozenset(v)) for k, v in mapping.items() if v))


def _to_dict(mapping: Tuple[Tuple[str, FrozenSet[int]], ...]) -> dict:
    return {k: set(v) for k, v in mapping}


def semantics(phi: CEL, stream: Sequence[Event]) -> Set[_Val]:
    """``⟦φ⟧(S)`` — the set of valuations of φ over (a finite prefix of) S."""
    if isinstance(phi, EventType):
        out = set()
        for i, t in enumerate(stream):
            if t.type == phi.name:
                out.add((i, i, _mk({phi.name: {i}})))
        return out
    if isinstance(phi, As):
        out = set()
        for (i, j, mu) in semantics(phi.child, stream):
            d = _to_dict(mu)
            gathered = set()
            for positions in d.values():
                gathered |= positions
            d[phi.var] = d.get(phi.var, set()) | gathered
            out.add((i, j, _mk(d)))
        return out
    if isinstance(phi, Filter):
        out = set()
        for (i, j, mu) in semantics(phi.child, stream):
            d = _to_dict(mu)
            positions = d.get(phi.var, set())
            if all(phi.pred.evaluate(stream[p]) for p in positions):
                out.add((i, j, mu))
        return out
    if isinstance(phi, Or):
        return semantics(phi.left, stream) | semantics(phi.right, stream)
    if isinstance(phi, Seq):
        lefts = semantics(phi.left, stream)
        rights = semantics(phi.right, stream)
        out = set()
        for (i1, j1, mu1) in lefts:
            for (i2, j2, mu2) in rights:
                if j1 < i2:  # V1(end) < V2(start)
                    d = _to_dict(mu1)
                    d2 = _to_dict(mu2)
                    for k, v in d2.items():
                        d[k] = d.get(k, set()) | v
                    out.add((i1, j2, _mk(d)))
        return out
    if isinstance(phi, Plus):
        base = semantics(phi.child, stream)
        out = set(base)
        frontier = set(base)
        # fixpoint: φ+ = φ OR (φ+ ; φ)
        while frontier:
            new = set()
            for (i1, j1, mu1) in frontier:
                for (i2, j2, mu2) in base:
                    if j1 < i2:
                        d = _to_dict(mu1)
                        d2 = _to_dict(mu2)
                        for k, v in d2.items():
                            d[k] = d.get(k, set()) | v
                        cand = (i1, j2, _mk(d))
                        if cand not in out:
                            new.add(cand)
            out |= new
            frontier = new
        return out
    if isinstance(phi, Proj):
        out = set()
        for (i, j, mu) in semantics(phi.child, stream):
            d = {k: v for k, v in _to_dict(mu).items() if k in phi.keep}
            out.add((i, j, _mk(d)))
        return out
    raise TypeError(f"unknown CEL node {phi!r}")


def complex_events(phi: CEL, stream: Sequence[Event], epsilon=None) -> Set[Tuple[int, int, Tuple[int, ...]]]:
    """``⟦φ⟧(S)`` under the complex-event semantics, optionally windowed."""
    out = set()
    for (i, j, mu) in semantics(phi, stream):
        if epsilon is not None and j - i > epsilon:
            continue
        data = set()
        for _, positions in mu:
            data |= positions
        out.add((i, j, tuple(sorted(data))))
    return out
