"""Fault-tolerance primitives: retries, heartbeats, straggler detection.

Host-side and hardware-agnostic (the standard library only), so CPU tests
exercise them:

* ``run_with_retries`` — retries a step on transient failure with exponential
  backoff + decorrelating jitter and an optional per-attempt timeout;
  re-raises after the budget (the caller then restarts and restores from
  the last checkpoint — crash-only design).  Errors on the ``non_retryable``
  deny-list propagate immediately: they signal *state* problems
  (window-overflow latches, compat-manifest mismatches) that a retry
  would only repeat against corrupt or incompatible state.  A
  per-attempt timeout is crash-only too, unless ``retry_timeouts`` opts
  in: the expired attempt cannot be killed, only abandoned, so it may
  still be mutating shared state while a retry re-enters the step.
* ``HeartbeatMonitor`` — background thread that flags a hang when the main
  loop stops beating (watchdog for hangs: a stalled device or collective is
  usually silent, not an exception).
* ``StepTimer`` — per-step timing stats; flags stragglers when a step
  exceeds ``threshold × median`` (feeds metrics and tests).
"""
from __future__ import annotations

import concurrent.futures
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional


@dataclass
class RetryPolicy:
    """Retry budget for one logical step.

    ``non_retryable`` is an explicit deny-list checked *before*
    ``retryable`` — even when an error type matches both (e.g. a
    compat-manifest ``ValueError`` configured retryable by a caller), the
    deny-list wins, so state-corruption signals never burn retry budget.
    ``jitter`` decorrelates the backoff: each sleep is scaled by a uniform
    factor in ``[1, 1 + jitter]`` so restarted replicas don't retry in
    lockstep.  ``timeout_s`` bounds each attempt; an attempt that exceeds
    it raises :class:`AttemptTimeout` (a ``TimeoutError``).  Timeouts are
    **not retried** by default even though ``TimeoutError`` is an
    ``OSError``: the expired attempt is abandoned, not killed, so for a
    step that updates state in place (every engine feed) an in-process
    retry races the still-running attempt — the chunk could be applied
    twice or concurrently.  Crash-only recovery (restart + checkpoint
    restore) is the safe path; ``retry_timeouts=True`` opts pure,
    side-effect-free steps back into backoff-retry on expiry.
    """

    max_retries: int = 3
    backoff_s: float = 0.1
    backoff_mult: float = 2.0
    jitter: float = 0.1
    timeout_s: Optional[float] = None
    retry_timeouts: bool = False
    retryable: tuple = (RuntimeError, OSError)
    non_retryable: tuple = ()


class AttemptTimeout(TimeoutError):
    """A per-attempt deadline expired; the attempt is abandoned but may
    still be running (Python threads cannot be cancelled)."""


def _call_with_timeout(fn: Callable, timeout_s: float, args, kwargs):
    """One attempt with a wall-clock deadline.

    The attempt runs in a worker thread and the deadline is enforced by
    ``Future.result(timeout)``; on expiry the worker CANNOT be killed
    (Python has no thread cancellation), so it is abandoned — the
    executor is shut down without waiting and the orphaned attempt runs
    to completion in the background.  That is why ``run_with_retries``
    treats the resulting :class:`AttemptTimeout` as crash-only by
    default: a device step may still be updating the engine's state
    buffers in place, so the only safe recovery is a process restart
    through the checkpoint/restore path, not an in-process re-feed.  The
    worker thread starts on CUDA device 0: a step must name its tensors'
    device, as the engines and kernel wrappers do.  Deliberately not
    a ``with`` block: the context manager would join the hung worker and
    never return.
    """
    ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    try:
        fut = ex.submit(fn, *args, **kwargs)
        try:
            return fut.result(timeout=timeout_s)
        except concurrent.futures.TimeoutError:
            raise AttemptTimeout(
                f"step exceeded per-attempt timeout of {timeout_s:.3f}s")
    finally:
        ex.shutdown(wait=False)


def run_with_retries(fn: Callable, policy: RetryPolicy, *args, **kwargs):
    delay = policy.backoff_s
    last = None
    for attempt in range(policy.max_retries + 1):
        try:
            if policy.timeout_s is not None:
                return _call_with_timeout(fn, policy.timeout_s, args, kwargs)
            return fn(*args, **kwargs)
        except policy.non_retryable:   # state problem: retrying repeats it
            raise
        except policy.retryable as e:  # transient: backoff and retry
            if isinstance(e, AttemptTimeout) and not policy.retry_timeouts:
                raise              # abandoned attempt may still be running
            last = e
            if attempt == policy.max_retries:
                raise
            time.sleep(delay * (1.0 + policy.jitter * random.random()))
            delay *= policy.backoff_mult
    raise last  # pragma: no cover


class HeartbeatMonitor:
    def __init__(self, timeout_s: float = 300.0, poll_s: float = 1.0,
                 on_hang: Optional[Callable[[], None]] = None):
        self.timeout_s = timeout_s
        self.poll_s = poll_s
        self.on_hang = on_hang
        self._last_beat = time.monotonic()
        self._stop = threading.Event()
        self._hung = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self) -> None:
        self._last_beat = time.monotonic()

    @property
    def hung(self) -> bool:
        return self._hung.is_set()

    def start(self) -> "HeartbeatMonitor":
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join()

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_s):
            if time.monotonic() - self._last_beat > self.timeout_s:
                self._hung.set()
                if self.on_hang:
                    self.on_hang()
                return


class StepTimer:
    """Rolling step-time stats + straggler flagging."""

    def __init__(self, window: int = 64, straggler_factor: float = 3.0):
        self.window = window
        self.factor = straggler_factor
        self.times: List[float] = []
        self.stragglers: List[int] = []
        self._t0: Optional[float] = None
        self._step = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.observe(dt)
        return False

    def observe(self, dt: float) -> bool:
        """Record a step time; returns True when flagged as straggler."""
        hist = self.times[-self.window:]
        is_straggler = bool(hist) and len(hist) >= 8 and \
            dt > self.factor * sorted(hist)[len(hist) // 2]
        self.times.append(dt)
        if is_straggler:
            self.stragglers.append(self._step)
        self._step += 1
        return is_straggler

    @property
    def median(self) -> float:
        hist = self.times[-self.window:]
        return sorted(hist)[len(hist) // 2] if hist else 0.0
