"""Predicates and the bit-vector tuple representation (paper §3, §5.4).

A (unary) predicate is a set of data-tuples.  CORE collects all *atomic*
predicates of a query into an indexed list ``P_1..P_k`` and represents each
incoming tuple ``t`` as the bit-vector ``v_t`` with ``v_t[i] = 1  iff  t ⊨ P_i``.
Every transition predicate of the compiled CEA is then a boolean formula over
bit indices (a :class:`BitExpr`), so it is evaluated on the bit-vector alone —
each attribute comparison is computed exactly once per tuple (paper §5.4).
"""
from __future__ import annotations

import operator
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .events import NULL, Event

# ---------------------------------------------------------------------------
# Attribute-level atomic predicates
# ---------------------------------------------------------------------------

_OPS: Dict[str, Callable[[Any, Any], bool]] = {
    "==": operator.eq,
    "!=": operator.ne,
    "<": operator.lt,
    "<=": operator.le,
    ">": operator.gt,
    ">=": operator.ge,
}


@dataclass(frozen=True)
class AtomicPredicate:
    """``t[attr] <op> constant`` — or a type test when ``attr == 'type'``."""

    attr: str
    op: str
    value: Any

    def evaluate(self, t: Event) -> bool:
        lhs = t.get(self.attr)
        if lhs is NULL:
            return False
        try:
            return _OPS[self.op](lhs, self.value)
        except TypeError:
            return False

    def __str__(self) -> str:
        return f"{self.attr}{self.op}{self.value!r}"


def type_predicate(event_type: str) -> AtomicPredicate:
    """``P_R := {t | t(type) = R}`` (paper Fig. 10)."""
    return AtomicPredicate("type", "==", event_type)


# ---------------------------------------------------------------------------
# Attribute-level predicate formulas (used by FILTER before CEA compilation)
# ---------------------------------------------------------------------------


class PredExpr:
    """Boolean formula over :class:`AtomicPredicate` leaves."""

    def evaluate(self, t: Event) -> bool:
        raise NotImplementedError

    def atoms(self) -> List[AtomicPredicate]:
        raise NotImplementedError


@dataclass(frozen=True)
class PAtom(PredExpr):
    atom: AtomicPredicate

    def evaluate(self, t):
        return self.atom.evaluate(t)

    def atoms(self):
        return [self.atom]


@dataclass(frozen=True)
class PAnd(PredExpr):
    left: PredExpr
    right: PredExpr

    def evaluate(self, t):
        return self.left.evaluate(t) and self.right.evaluate(t)

    def atoms(self):
        return self.left.atoms() + self.right.atoms()


@dataclass(frozen=True)
class POr(PredExpr):
    left: PredExpr
    right: PredExpr

    def evaluate(self, t):
        return self.left.evaluate(t) or self.right.evaluate(t)

    def atoms(self):
        return self.left.atoms() + self.right.atoms()


@dataclass(frozen=True)
class PNot(PredExpr):
    child: PredExpr

    def evaluate(self, t):
        return not self.child.evaluate(t)

    def atoms(self):
        return self.child.atoms()


@dataclass(frozen=True)
class PTrue(PredExpr):
    def evaluate(self, t):
        return True

    def atoms(self):
        return []


# ---------------------------------------------------------------------------
# Bit-level formulas (transition predicates after atom indexing)
# ---------------------------------------------------------------------------


class BitExpr:
    """Boolean formula over bit positions of the query's bit-vector."""

    def evaluate(self, bitvec: int) -> bool:
        raise NotImplementedError


@dataclass(frozen=True)
class BTrue(BitExpr):
    def evaluate(self, bitvec: int) -> bool:
        return True

    def __str__(self):
        return "TRUE"


@dataclass(frozen=True)
class BLit(BitExpr):
    bit: int
    positive: bool = True

    def evaluate(self, bitvec: int) -> bool:
        val = bool((bitvec >> self.bit) & 1)
        return val if self.positive else not val

    def __str__(self):
        return f"b{self.bit}" if self.positive else f"!b{self.bit}"


@dataclass(frozen=True)
class BAnd(BitExpr):
    left: BitExpr
    right: BitExpr

    def evaluate(self, bitvec: int) -> bool:
        return self.left.evaluate(bitvec) and self.right.evaluate(bitvec)

    def __str__(self):
        return f"({self.left} & {self.right})"


@dataclass(frozen=True)
class BOr(BitExpr):
    left: BitExpr
    right: BitExpr

    def evaluate(self, bitvec: int) -> bool:
        return self.left.evaluate(bitvec) or self.right.evaluate(bitvec)

    def __str__(self):
        return f"({self.left} | {self.right})"


@dataclass(frozen=True)
class BNot(BitExpr):
    child: BitExpr

    def evaluate(self, bitvec: int) -> bool:
        return not self.child.evaluate(bitvec)

    def __str__(self):
        return f"!{self.child}"


# ---------------------------------------------------------------------------
# Atom registry: assigns bit indices and evaluates whole tuples to bit-vectors
# ---------------------------------------------------------------------------


class AtomRegistry:
    """Indexes the distinct atomic predicates of a query (paper §5.4).

    ``bitvector(t)`` evaluates each atomic predicate exactly once for tuple
    ``t`` and returns the packed integer bit-vector used as the tuple's internal
    representation by both the host engine and the device engine.
    """

    def __init__(self) -> None:
        self._atoms: List[AtomicPredicate] = []
        self._index: Dict[AtomicPredicate, int] = {}

    def register(self, atom: AtomicPredicate) -> int:
        idx = self._index.get(atom)
        if idx is None:
            idx = len(self._atoms)
            self._atoms.append(atom)
            self._index[atom] = idx
        return idx

    def lower(self, expr: PredExpr) -> BitExpr:
        """Rewrite an attribute-level formula into a bit-level formula."""
        if isinstance(expr, PTrue):
            return BTrue()
        if isinstance(expr, PAtom):
            return BLit(self.register(expr.atom))
        if isinstance(expr, PAnd):
            return BAnd(self.lower(expr.left), self.lower(expr.right))
        if isinstance(expr, POr):
            return BOr(self.lower(expr.left), self.lower(expr.right))
        if isinstance(expr, PNot):
            return BNot(self.lower(expr.child))
        raise TypeError(f"unknown predicate expression {expr!r}")

    @property
    def atoms(self) -> Sequence[AtomicPredicate]:
        return tuple(self._atoms)

    @property
    def num_bits(self) -> int:
        return len(self._atoms)

    def bitvector(self, t: Event) -> int:
        v = 0
        for i, atom in enumerate(self._atoms):
            if atom.evaluate(t):
                v |= 1 << i
        return v

    def specs(self) -> List[Tuple[str, str, Any]]:
        """(attr, op, value) triples — consumed by the device bit-vector kernel."""
        return [(a.attr, a.op, a.value) for a in self._atoms]
