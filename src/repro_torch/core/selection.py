"""Selection strategies (paper §2, §6 'Selection strategies'; semantics in [31]).

CORE supports ALL (the default skip-till-any-match), NXT, LAST, MAX and — in
this repo's dialect — STRICT (contiguous matches only).  The paper implements
these at the automaton level via a strategy-aware determinization; the device
engines now do the same (``compile_symbolic(cea, strategy=…)``, DESIGN.md D2).
The reducers in this module are the *host oracle*: result-level subset
selectors applied to the per-position output set, used by the host
``Executor``, by ALL-compiled engines asked to post-filter at enumeration
time, and by the parity tests that pin the device tables to these semantics.

Definitions used (per position j, over the set M_j of matches ending at j):

* ``MAX``    — keep C ∈ M_j iff no C' ∈ M_j with same interval start and
  C.data ⊊ C'.data (maximal sequences; the paper's Q3 segmentation use-case).
* ``LAST``   — keep the matches with the latest start; ties broken by keeping
  maximal data sets.
* ``NXT``    — keep, per start position, the lexicographically earliest data
  set (the "next"/earliest-match heuristic).
* ``STRICT`` — keep C ∈ M_j iff its data set covers every position of its
  interval (``len(data) == end - start + 1``: strict contiguity).

The reducers operate on *enumerated* results — host tECS or device-arena
alike (ComplexEvents from :meth:`ArenaSnapshot.enumerate` carry plain-int
positions and arrive in DFS order, which none of the reducers depend on).
Strategies are defined per position ``j`` over the set ``M_j`` of matches
closing at ``j``: use :func:`apply_strategy_per_position` for a flat list
spanning several positions (e.g. all hits of a streamed chunk) — applying
``LAST``/``NXT`` across positions would silently compare unrelated ``M_j``.
"""
from __future__ import annotations

from typing import Dict, Iterable, List

from .events import ComplexEvent

STRATEGIES = ("ALL", "ANY", "MAX", "LAST", "NXT", "NEXT", "STRICT")


def apply_strategy(strategy: str, matches: Iterable[ComplexEvent]
                   ) -> List[ComplexEvent]:
    """Reduce the matches of ONE closing position under ``strategy``."""
    if strategy not in STRATEGIES:
        # Validate before the empty-list early return: a bogus strategy name
        # must raise even when there is nothing to filter.
        raise ValueError(f"unknown selection strategy {strategy!r}")
    matches = list(matches)
    if strategy in ("ALL", "ANY") or not matches:
        return matches
    if strategy == "MAX":
        out = []
        for c in matches:
            dominated = any(
                c2 is not c and c2.start == c.start and
                set(c.data) < set(c2.data)
                for c2 in matches)
            if not dominated:
                out.append(c)
        return out
    if strategy == "LAST":
        best = max(c.start for c in matches)
        latest = [c for c in matches if c.start == best]
        return apply_strategy("MAX", latest)
    if strategy in ("NXT", "NEXT"):
        per_start: Dict[int, ComplexEvent] = {}
        for c in matches:
            cur = per_start.get(c.start)
            if cur is None or c.data < cur.data:
                per_start[c.start] = c
        return [per_start[k] for k in sorted(per_start)]
    # strategy == "STRICT": strict contiguity — every position in
    # [start, end] is in data
    return [c for c in matches
            if len(c.data) == c.end - c.start + 1]


def apply_strategy_per_position(strategy: str,
                                matches: Iterable[ComplexEvent]
                                ) -> List[ComplexEvent]:
    """Reduce a flat enumerated list position-by-position.

    Selection strategies (ALL/ANY, MAX, LAST, NXT, STRICT — see the module
    docstring) are subset selectors of ``M_j`` — the matches closing at one
    position ``j``.  A chunk's enumerated arena results span many positions;
    this groups them by ``end`` and reduces each group independently,
    returning groups in ascending position order.
    """
    groups: Dict[int, List[ComplexEvent]] = {}
    for c in matches:
        groups.setdefault(int(c.end), []).append(c)
    out: List[ComplexEvent] = []
    for j in sorted(groups):
        out.extend(apply_strategy(strategy, groups[j]))
    return out
