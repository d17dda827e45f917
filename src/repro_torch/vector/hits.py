"""The hit list of a streaming feed, held as columns.

A feed of ``(chunk_len, B)`` positions over thousands of lanes can end a
match at a third of them; a Python tuple per hit then costs the host more
than the device's scan.  :class:`HitList` keeps the absolute positions and
the lanes as two int64 arrays and makes a ``(position, lane)`` tuple only
for the caller that asks for one.
"""
from __future__ import annotations

import operator
from collections.abc import Sequence

import numpy as np


def _frozen(a) -> np.ndarray:
    """A read-only int64 view of ``a`` (the caller's array stays
    writeable)."""
    a = np.asarray(a, np.int64).view()
    a.flags.writeable = False
    return a


class HitList(Sequence):
    """Absolute ``(position, stream)`` pairs with at least one match, in
    row-major order (position first, then lane).

    Iteration and indexing give tuples of Python ints, a slice gives a
    :class:`HitList`, ``np.asarray(hits)`` gives the ``(n, 2)`` int64
    pairs (``(0, 2)`` when empty), and a hit list equals any sequence of
    the same pairs in the same order."""

    __slots__ = ("positions", "lanes")

    def __init__(self, positions, lanes):
        self.positions = _frozen(positions)
        self.lanes = _frozen(lanes)
        if self.positions.ndim != 1 or \
                self.positions.shape != self.lanes.shape:
            raise ValueError(
                f"hit columns are two 1-D arrays of one length; got shapes "
                f"{self.positions.shape} and {self.lanes.shape}")

    @classmethod
    def of_counts(cls, counts: np.ndarray, base: int = 0) -> "HitList":
        """The ``(base + t, b)`` pairs where ``counts`` ``(T, B)``, or
        ``(T, B, Q)`` with a query axis, has a nonzero count (in any
        query)."""
        hit = counts != 0
        if hit.ndim == 3:
            # OR of the query columns: faster than .any(-1) on a short axis
            nz, hit = hit, np.zeros(hit.shape[:2], bool)
            for q in range(nz.shape[2]):
                hit |= nz[..., q]
        t, b = np.divmod(np.flatnonzero(hit), hit.shape[1])
        return cls(t + base, b)

    def __len__(self) -> int:
        return self.positions.size

    def __bool__(self) -> bool:
        return self.positions.size > 0

    def __getitem__(self, i):
        if isinstance(i, slice):
            return HitList(self.positions[i], self.lanes[i])
        i = operator.index(i)
        return int(self.positions[i]), int(self.lanes[i])

    def __iter__(self):
        return zip(self.positions.tolist(), self.lanes.tolist())

    def __eq__(self, other):
        if isinstance(other, HitList):
            return (np.array_equal(self.positions, other.positions)
                    and np.array_equal(self.lanes, other.lanes))
        if not isinstance(other, Sequence) or isinstance(other, str):
            return NotImplemented
        return len(other) == len(self) and all(
            isinstance(h, (tuple, list)) and tuple(h) == mine
            for h, mine in zip(other, self))

    __hash__ = None

    def __add__(self, other):
        if isinstance(other, (list, tuple, HitList)):
            return self.tolist() + list(other)
        return NotImplemented

    def __radd__(self, other):
        if isinstance(other, (list, tuple)):
            return list(other) + self.tolist()
        return NotImplemented

    def __array__(self, dtype=None, copy=None):
        if copy is False:
            raise ValueError("a HitList's (n, 2) array is always a new one")
        pairs = np.stack([self.positions, self.lanes], axis=1)
        return pairs if dtype is None else pairs.astype(dtype, copy=False)

    def tolist(self) -> list:
        return list(self)

    def __repr__(self) -> str:
        return f"HitList({self.tolist()!r})"
