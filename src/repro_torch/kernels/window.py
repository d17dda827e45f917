"""Device windows: one `DeviceWindow` drives every layer of the port.

CEQL's ``WITHIN`` clause is either count-based (``WITHIN n events``) or
time-based (``WITHIN 30000 [stock_time]``).  A compiled query's
``WindowSpec`` resolves into one static :class:`DeviceWindow` that the
encoder, the fused-scan kernel and the streaming engine consume.

The state ring ``C[B, W, S]`` is indexed by ``start mod W`` in both modes;
event ``j`` always seeds slot ``j mod W``.  Only eviction differs:

* ``events`` — exactly the start that just left the window, slot
  ``(j - ε - 1) mod W``, expires each step (``W ≥ ε+1``).
* ``time``  — a per-slot start-timestamp ring ``ts[B, W]`` accompanies the
  counts; at event ``j`` with timestamp ``τ_j`` every slot with
  ``ts < τ_j - size`` is cleared.  ``W`` is then a rate bound
  (``max_window_events``): when event ``j`` must seed a slot whose start is
  still inside the window, the lane's ``ovf`` flag latches and the slot is
  overwritten — counts on that lane become a lower bound.

Timestamps are f32 on the device; the host engine compares float64, so the
two agree whenever timestamps and the window size are exact in f32 (integer
milliseconds below 2^24, as the stock benchmarks use).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

#: default rate bound (ring slots) for time windows when the caller gives
#: no ``max_window_events``
DEFAULT_MAX_WINDOW_EVENTS = 64


class WindowOverflowError(Exception):
    """A lane's time-window rate bound was exceeded (``strict_overflow``).

    Raised by the streaming engine after the chunk was applied, when the
    per-lane ``ovf`` latch tripped.  Not a ``RuntimeError``: the latch is
    persistent, so retrying the chunk would corrupt state.  ``lanes`` holds
    the latched lane indices.
    """

    def __init__(self, lanes):
        self.lanes = [int(l) for l in lanes]
        super().__init__(
            f"time-window rate bound exceeded on lane(s) {self.lanes}: more "
            "than max_window_events starts were simultaneously live; counts "
            "on these lanes are now a lower bound.  Raise "
            "max_window_events=, or drop strict_overflow to degrade "
            "silently")


def _pad8(x: int) -> int:
    """Ring sizes are multiples of 8, as the reference package sizes them,
    so that snapshots of either package restore into the other."""
    return ((x + 7) // 8) * 8


@dataclass(frozen=True)
class DeviceWindow:
    """Static window descriptor resolved from a query's ``WindowSpec``.

    kind:       'events' | 'time'
    size:       ε for count windows; the time span for time windows
    time_attr:  attribute holding the timestamp (time windows; None ⇒ event
                arrival timestamps, falling back to stream position)
    ring:       ring slots W; ``W ≥ ε+1`` for count windows, the rate bound
                for time windows
    """

    kind: str
    size: float
    time_attr: Optional[str] = None
    ring: int = 8

    def __post_init__(self):
        if self.kind not in ("events", "time"):
            raise ValueError(f"window kind must be 'events' or 'time', "
                             f"got {self.kind!r}")
        if self.kind == "events" and self.ring < int(self.size) + 1:
            raise ValueError(f"ring {self.ring} < epsilon+1 "
                             f"({int(self.size) + 1})")

    @property
    def is_time(self) -> bool:
        return self.kind == "time"

    @property
    def epsilon(self) -> int:
        """The query's ε for count windows; ``ring - 1`` for time windows
        (every live start sits within the last ``ring`` positions)."""
        return int(self.size) if self.kind == "events" else self.ring - 1

    def regrow(self, max_window_events: int) -> "DeviceWindow":
        """A copy of this time window with a larger rate bound.  Count
        windows cannot regrow and shrinking is refused."""
        if not self.is_time:
            raise ValueError(
                "only time windows regrow: a count window's ring is sized "
                "from its epsilon and can never overflow")
        new_ring = _pad8(int(max_window_events))
        if new_ring < self.ring:
            raise ValueError(
                f"ring regrow cannot shrink: max_window_events="
                f"{int(max_window_events)} pads to {new_ring} < current "
                f"ring {self.ring}")
        return DeviceWindow(self.kind, self.size, self.time_attr, new_ring)

    @staticmethod
    def events(epsilon: int) -> "DeviceWindow":
        return DeviceWindow("events", float(int(epsilon)),
                            ring=_pad8(int(epsilon) + 1))

    @staticmethod
    def time(size: float, time_attr: Optional[str] = None,
             max_window_events: Optional[int] = None) -> "DeviceWindow":
        mwe = (DEFAULT_MAX_WINDOW_EVENTS if max_window_events is None
               else int(max_window_events))
        if mwe < 1:
            raise ValueError(f"max_window_events must be ≥ 1, got {mwe}")
        return DeviceWindow("time", float(size), time_attr, ring=_pad8(mwe))


def resolve_window(spec, *, epsilon: Optional[int] = None,
                   max_window_events: Optional[int] = None) -> DeviceWindow:
    """Resolve a query's parsed ``WindowSpec`` (+ legacy kwargs).

    The query's ``WITHIN`` clause is authoritative: an ``epsilon=`` that
    contradicts it raises, ``max_window_events`` is only accepted for time
    windows, and a query without ``WITHIN`` needs ``epsilon=`` (with a
    deprecation warning).
    """
    kind = getattr(spec, "kind", "none") if spec is not None else "none"
    if kind != "time" and max_window_events is not None:
        raise ValueError(
            "max_window_events= sizes the rate bound of a TIME window; "
            "this query's window is count-based (the ring is sized from "
            "its epsilon) — drop the kwarg or declare a time WITHIN")
    if kind == "events":
        n = int(spec.size)
        if epsilon is not None and int(epsilon) != n:
            raise ValueError(
                f"epsilon={int(epsilon)} contradicts the query's own "
                f"'WITHIN {n} events' clause — drop the epsilon= kwarg")
        return DeviceWindow.events(n)
    if kind == "time":
        if epsilon is not None:
            raise ValueError(
                f"epsilon={int(epsilon)} is a count window but the query "
                f"declares a time window (WITHIN {spec.size:g}"
                + (f" [{spec.time_attr}]" if spec.time_attr else " seconds")
                + ") — drop the epsilon= kwarg; size the ring with "
                  "max_window_events= instead")
        return DeviceWindow.time(spec.size, spec.time_attr,
                                 max_window_events)
    if epsilon is None:
        raise ValueError(
            "device engines need a bounded window: the query has no WITHIN "
            "clause and no epsilon= was given.  Add 'WITHIN n events' (or a "
            "time window) to the query")
    warnings.warn(
        "passing epsilon= for a query without a WITHIN clause is "
        "deprecated — declare the window in the query ('WITHIN "
        f"{int(epsilon)} events'); the kwarg remains only as a shim",
        DeprecationWarning, stacklevel=3)
    return DeviceWindow.events(int(epsilon))


#: timestamp-ring fill for never-seeded slots: reads as "expired forever"
TS_EMPTY = -np.inf

State = Union[torch.Tensor, dict]


def init_state(window: DeviceWindow, batch: int, num_states: int,
               device="cpu") -> State:
    """Fresh scan state on ``device``.

    Count windows keep the bare ``(B, W, S)`` f32 ring; time windows carry
    ``{"C": (B, W, S) f32, "ts": (B, W) f32, "ovf": (B,) bool}``, with
    ``ts`` = ``TS_EMPTY`` for never-seeded slots.
    """
    C = torch.zeros((batch, window.ring, num_states), dtype=torch.float32,
                    device=device)
    if not window.is_time:
        return C
    return {"C": C,
            "ts": torch.full((batch, window.ring), TS_EMPTY,
                             dtype=torch.float32, device=device),
            "ovf": torch.zeros((batch,), dtype=torch.bool, device=device)}


def window_overflow(state: State) -> np.ndarray:
    """Per-lane latched rate-bound flags (all-False for count windows)."""
    if isinstance(state, dict):
        if "ovf" in state:
            return state["ovf"].cpu().numpy()
        # the streaming engine's {"C": <window state>, "arena": ...}
        return window_overflow(state["C"])
    return np.zeros(state.shape[0], bool)


def require_count_scan(window: DeviceWindow) -> None:
    """Guard of the count-window scan entry points (``scan()``)."""
    if window.is_time:
        raise ValueError("scan() drives the count-window scan kernels; "
                         "time-window queries evaluate through "
                         "pipeline()/run()")


def ring_slot_remap(old_ring: int, new_ring: int, next_pos: np.ndarray
                    ) -> tuple:
    """Per-lane slot mapping from a W0 ring onto a larger W1 ring.

    Old slot ``k`` of a lane whose next-seed position is ``p`` last held
    start ``j = p-1 - ((p-1-k) mod W0)``; on the W1 ring that start belongs
    at ``j mod W1``.  Returns ``(new_slot, valid)``, both ``(B, W0)``;
    ``valid`` masks slots whose start would predate the stream (``j < 0``).
    """
    if new_ring < old_ring:
        raise ValueError(f"ring remap cannot shrink ({old_ring} → "
                         f"{new_ring})")
    p = np.asarray(next_pos, np.int64).reshape(-1, 1)          # (B, 1)
    k = np.arange(old_ring, dtype=np.int64)[None, :]           # (1, W0)
    j = p - 1 - ((p - 1 - k) % old_ring)                       # (B, W0)
    return (j % new_ring).astype(np.int64), j >= 0


def audit_monotone_ts(ts, last: Optional[np.ndarray] = None) -> np.ndarray:
    """Raise unless timestamps are finite and non-decreasing along T.

    ``ts`` is ``(T, B)`` or ``(T,)`` (numpy or a tensor); ``last`` carries
    each lane's previous chunk-final timestamp across feeds.  Returns the
    new ``last`` row.
    """
    if isinstance(ts, torch.Tensor):
        ts = ts.cpu().numpy()
    ts = np.asarray(ts, np.float32)
    flat = ts.reshape(ts.shape[0], -1)
    if not np.isfinite(flat).all():
        raise ValueError("time-window timestamps must be finite")
    seq = flat if last is None else np.concatenate(
        [np.asarray(last, np.float32).reshape(1, -1), flat])
    if (np.diff(seq, axis=0) < 0).any():
        t_bad, b_bad = np.argwhere(np.diff(seq, axis=0) < 0)[0]
        raise ValueError(
            f"time-window streams must be monotone in time (stream order = "
            f"time order): timestamp decreases at step {int(t_bad)} of lane "
            f"{int(b_bad)} (chunk-local; previous-chunk boundary = step 0 "
            "when carrying over)")
    return flat[-1].copy()
