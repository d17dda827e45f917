"""Top-level CEQL query execution: parse → compile → evaluate.

This is the public API of the host (reference) engine::

    q = compile_query("SELECT * FROM S WHERE A as x ; B as y WITHIN 10")
    for pos, match in q.run(stream):
        ...
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

from . import ceql
from .cea import CEA, compile_cel
from .engine import Engine, WindowSpec
from .events import ComplexEvent, Event
from .partition import PartitionedEngine
from .predicates import AtomRegistry
from .selection import apply_strategy


@dataclass(frozen=True)
class DeviceSemantics:
    """What the device engines must compile for a query's semantics.

    * ``construction`` — the strategy-aware determinization to build
      (``compile_symbolic(cea, strategy=construction)``): one of
      ALL / STRICT / MAX / NXT.  LAST shares MAX tables.
    * ``latest``  — reduce per-slot counts to the latest live seed slot
      (LAST's second half; slots ↔ seed positions inside the window).
    * ``consume`` — CONSUME BY ANY: clear the query's ring states and arena
      cells after any position that emits (host emit-then-clear order).
    """

    construction: str
    latest: bool
    consume: bool


def resolve_semantics(query: ceql.Query) -> DeviceSemantics:
    """Resolve a query's strategy + CONSUME clause for the device path.

    Raises ``ValueError`` for semantics no device engine can honor —
    mirroring ``kernels.window.resolve_window``'s contradiction errors, so
    an unsupported query can never silently run under ANY semantics.
    """
    strat = query.strategy
    construction = {"ALL": "ALL", "ANY": "ALL", "STRICT": "STRICT",
                    "MAX": "MAX", "LAST": "MAX",
                    "NXT": "NXT", "NEXT": "NXT"}.get(strat)
    if construction is None:
        raise ValueError(
            f"device engines do not implement selection strategy {strat!r}")
    consume = bool(query.consume_on_match)
    if consume and strat == "STRICT":
        # Host CONSUME BY ANY triggers on the *unfiltered* (ANY) match set —
        # the Executor applies the strategy after the engine has already
        # consumed.  MAX/LAST/NXT-filtered sets are non-empty exactly when
        # the ANY set is, so their compiled triggers coincide; STRICT's does
        # not (a position can have ANY-matches but no contiguous one), so
        # strict tables cannot reproduce the host's consumption points.
        raise ValueError(
            "device engines cannot honor CONSUME BY ANY under STRICT: "
            "the consumption trigger (any match) is not observable from "
            "strict-compiled tables; use the host engine for this query")
    return DeviceSemantics(construction=construction,
                           latest=(strat == "LAST"),
                           consume=consume)


@dataclass
class CompiledQuery:
    query: ceql.Query
    cea: CEA

    @property
    def semantics(self) -> DeviceSemantics:
        return resolve_semantics(self.query)

    def make_executor(self, max_enumerate: Optional[int] = None) -> "Executor":
        return Executor(self, max_enumerate=max_enumerate)

    def run(self, stream: Iterable[Event],
            max_enumerate: Optional[int] = None
            ) -> Iterator[Tuple[int, ComplexEvent]]:
        return self.make_executor(max_enumerate).run(stream)


class Executor:
    """Drives (possibly partitioned) engines and applies the selection strategy."""

    def __init__(self, compiled: CompiledQuery,
                 max_enumerate: Optional[int] = None):
        self.compiled = compiled
        q = compiled.query

        def make_engine() -> Engine:
            return Engine(compiled.cea, window=q.window,
                          consume_on_match=q.consume_on_match,
                          max_enumerate=max_enumerate)

        if q.partition_by:
            self.engine: object = PartitionedEngine(make_engine, q.partition_by)
        else:
            self.engine = make_engine()
        self.strategy = q.strategy
        self.j = -1

    def process(self, t: Event) -> List[ComplexEvent]:
        self.j += 1
        matches = self.engine.process(t)
        return apply_strategy(self.strategy, matches)

    def run(self, stream: Iterable[Event]) -> Iterator[Tuple[int, ComplexEvent]]:
        for t in stream:
            for ce in self.process(t):
                yield self.j, ce

    @property
    def stats(self):
        if isinstance(self.engine, PartitionedEngine):
            return [e.stats for e in self.engine.partitions.values()]
        return self.engine.stats


def compile_query(text: str, registry: Optional[AtomRegistry] = None
                  ) -> CompiledQuery:
    q = ceql.parse(text)
    cea = compile_cel(q.formula(), registry)
    return CompiledQuery(q, cea)
