"""Event model for CORE (paper §3).

Events are *data-tuples*: partial mappings from attribute names to data values,
each associated with an event type.  A stream is a (possibly unbounded) sequence
of data-tuples; CORE assigns each tuple the position at which it arrives.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Iterator, Optional

NULL = None  # paper: t(a) = NULL when t is undefined on attribute a


class Event:
    """A data-tuple ``t`` with an event type and attribute map.

    ``t(type)`` is exposed as ``.type``; ``t(a)`` as ``.get(a)`` (NULL if absent).
    ``position`` / ``timestamp`` are assigned by the engine on arrival (the paper
    assigns arrival order; time-attribute windows like ``WITHIN 30000 [stock_time]``
    read the timestamp from the named attribute instead).
    """

    __slots__ = ("type", "attrs", "position", "timestamp")

    def __init__(self, type: str, attrs: Optional[Dict[str, Any]] = None,
                 position: int = -1, timestamp: Optional[float] = None):
        self.type = type
        self.attrs = attrs or {}
        self.position = position
        self.timestamp = timestamp

    def get(self, attr: str) -> Any:
        if attr == "type":
            return self.type
        return self.attrs.get(attr, NULL)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Event({self.type}@{self.position} {self.attrs})"


@dataclass(frozen=True)
class ComplexEvent:
    """A complex event ``C = ([i, j], D)`` (paper §3).

    ``start``/``end`` are stream positions; ``data`` the sorted tuple of the
    positions of the relevant data-tuples (``D ⊆ {i..j}``).
    """

    start: int
    end: int
    data: tuple  # sorted tuple of positions

    @property
    def time(self):
        return (self.start, self.end)

    def __len__(self) -> int:
        return len(self.data)


@dataclass(frozen=True)
class Valuation:
    """A valuation ``V = ([i, j], μ)`` mapping variables to position sets."""

    start: int
    end: int
    mapping: tuple  # tuple of (variable, frozenset(positions)) sorted by variable

    def to_complex_event(self) -> ComplexEvent:
        data = set()
        for _, positions in self.mapping:
            data |= positions
        return ComplexEvent(self.start, self.end, tuple(sorted(data)))

    def var(self, name: str) -> frozenset:
        for var, positions in self.mapping:
            if var == name:
                return positions
        return frozenset()


def stream_from_types(types: Iterable[str], **attr_fns) -> Iterator[Event]:
    """Tiny helper: build a stream of attribute-less events from type names."""
    for i, t in enumerate(types):
        attrs = {k: fn(i) for k, fn in attr_fns.items()}
        yield Event(t, attrs, position=i, timestamp=float(i))


def assign_positions(stream: Iterable[Event], time_attr: Optional[str] = None
                     ) -> Iterator[Event]:
    """Assign arrival positions (and timestamps) to a raw stream of events.

    The paper: "each event is assigned the time at which it arrives to the
    system".  If ``time_attr`` is given, timestamps are read from that attribute
    (used by the stock queries' ``WITHIN 30000 [stock_time]``).
    """
    for i, ev in enumerate(stream):
        ev.position = i
        if time_attr is not None:
            ev.timestamp = float(ev.get(time_attr))
        elif ev.timestamp is None:
            ev.timestamp = float(i)
        yield ev
