"""Event-stream generators for the CER benchmarks (paper §6).

* ``random_stream`` — the paper's RandomStream: n query event types A1..An
  plus B1..B6 noise types, uniform probability.  Used by the sequence /
  iteration / disjunction / window experiments.
* ``stock_stream`` — synthetic stock-market stream shaped like the WPI Stock
  Trace data used in §6: BUY/SELL events with name, volume, price and a
  monotone ``stock_time`` in milliseconds at ≈ 4800 e/s (the rate the paper
  reports), so the paper's 30 s window holds ≈ 100 active events per name.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

from ..core.events import Event

NOISE_TYPES = [f"B{i}" for i in range(1, 7)]
STOCK_NAMES = ["MSFT", "ORCL", "CSCO", "AMAT", "AMZN", "INTC", "IBM", "DELL"]


@dataclass
class StreamSpec:
    query_types: Sequence[str]
    noise_types: Sequence[str] = tuple(NOISE_TYPES)
    seed: int = 0


def random_stream(spec: StreamSpec, length: int) -> List[Event]:
    rng = random.Random(spec.seed)
    types = list(spec.query_types) + list(spec.noise_types)
    return [Event(rng.choice(types), {}, position=i, timestamp=float(i))
            for i in range(length)]


def stock_stream(length: int, seed: int = 0, events_per_sec: float = 4803.0,
                 names: Optional[Sequence[str]] = None) -> List[Event]:
    rng = random.Random(seed)
    names = list(names or STOCK_NAMES)
    out: List[Event] = []
    t_ms = 0.0
    for i in range(length):
        t_ms += 1000.0 / events_per_sec
        name = rng.choice(names)
        out.append(Event(
            rng.choice(("BUY", "SELL")),
            {"name": name,
             "volume": float(rng.choice((100, 200, 500, 1000))),
             "price": round(rng.uniform(5.0, 50.0), 2),
             "stock_time": t_ms},
            position=i, timestamp=t_ms / 1000.0))
    return out
