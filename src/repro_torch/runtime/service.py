"""Resilient streaming service runtime (DESIGN.md §12).

Everything below this module is a library call: feed a well-formed,
pre-encoded chunk and get counts back — and any malformed event, bursty
tenant, or window-overflow latch becomes the *caller's* exception.
:class:`StreamService` wraps a streaming engine behind the ingestion loop
a deployment actually needs:

* **Bounded ingress + explicit backpressure** — raw dict events enter
  through :meth:`StreamService.submit`, which returns a :class:`Receipt`
  rather than raising: ``accepted``, ``rejected`` (failed validation,
  routed to the dead-letter queue), ``shed_rate`` (tenant over its
  token-bucket budget), ``shed_backpressure`` (ingress buffer full,
  non-blocking submit), or ``timeout`` (blocking submit missed its
  deadline).  The buffer bound is ``queue_chunks × chunk_len`` events.
* **Host/device pipelining** — a dedicated encoder thread turns raw
  chunks into host tensors (pinned when the engine is on CUDA) while the
  device thread copies the previous chunk's to the engine's device and
  steps it (PyTorch releases the GIL while it waits on the device), so
  ``encode(n+1)`` overlaps ``step(n)``; the bounded hand-off queue
  (``pipeline_depth``) is the double buffer.  The copy is issued on the
  device thread, on the stream its feed then launches on, so it is
  ordered before the feed's kernels.
* **Dead-letter queue** — rejects land in a replayable JSONL file with
  the rejection reason and a durable per-event sequence number; restarts
  that re-submit the stream deduplicate by that sequence, and
  :meth:`DeadLetterQueue.replay` re-submits repaired events.
* **Crash recovery + retries** — device steps run under
  :class:`~repro_torch.runtime.recovery.RecoveringStreamRunner` (jittered
  backoff, per-attempt timeout, checkpoint/restore, exactly-once
  emission across kill -9 via the MatchLog high-water mark).
* **Alert sinks, at-least-once** — chunks with matches are delivered to
  every sink *after* their emission record is durable, and a cursor file
  advances after delivery; a restart re-delivers anything above the
  cursor (at-least-once — sinks deduplicate by chunk index, which the
  MatchLog makes stable across restarts).
* **Overflow self-healing** — a :class:`~repro_torch.kernels.window.
  WindowOverflowError` quarantines the latched lanes, regrows
  ``max_window_events`` through the elastic ring-migrating ``restore()``
  path, replays the retained chunks since the last checkpoint, and
  re-feeds the offending chunk — bursty streams degrade to higher memory
  instead of dying.  The chosen bound persists in a sidecar file so a
  crash mid-heal resumes the regrow on restart.

Threading contract: ``submit``/``drain``/``close`` must be called from
ONE producer thread; the service owns the encoder and device threads.
Worker errors surface as :class:`StreamServiceError` on the next
producer-side call.

Restart contract: a producer restarting over the same directory
re-submits the stream **from the beginning** in the original order
(at-least-once ingestion).  Chunks the restored checkpoint already
contains are skipped (their encode still runs so the stream clock
advances identically), chunks already on the emission log replay with
emission suppressed, and everything newer is fresh work — together:
exactly-once emission, at-least-once delivery.  Admission replays
deterministically: sheds recorded in the DLQ shed again by sequence
number, and live rate/backpressure shedding is bypassed while re-forming
chunks the emission log already covers — otherwise a refilled token
bucket or different queue timing would admit an event the original run
dropped, and the replayed chunk would diverge from its durable record.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.events import Event
from ..core.partition import partition_key
from ..kernels.window import WindowOverflowError, _pad8
from .fault_tolerance import RetryPolicy
from .recovery import RecoveringStreamRunner, _hit_key

_SCALARS = (str, int, float, bool)


class StreamServiceError(RuntimeError):
    """A service worker thread died or a heal exhausted its bound."""


# ----------------------------------------------------------------------
# admission control
# ----------------------------------------------------------------------
@dataclass
class Receipt:
    """Outcome of one :meth:`StreamService.submit` call.

    ``seq`` is the durable per-event sequence number (assigned to every
    submitted event, accepted or not, so reject records are stable across
    a producer replay).  ``reason`` is set for ``rejected`` receipts.
    """

    status: str            # accepted|rejected|shed_rate|shed_backpressure|timeout
    seq: int
    reason: Optional[str] = None

    @property
    def accepted(self) -> bool:
        return self.status == "accepted"


class TokenBucket:
    """Per-tenant token buckets: ``rate`` tokens/s, ``burst`` capacity.

    ``rate=0`` with ``burst=K`` admits exactly the first K events per
    tenant — deterministic, which the shed tests rely on.  ``now`` is
    injectable for deterministic refill in tests.
    """

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self._buckets: Dict[Any, Tuple[float, float]] = {}

    def allow(self, tenant, now: Optional[float] = None,
              cost: float = 1.0) -> bool:
        if now is None:
            now = time.monotonic()
        tokens, last = self._buckets.get(tenant, (self.burst, now))
        tokens = min(self.burst, tokens + self.rate * max(0.0, now - last))
        ok = tokens >= cost
        self._buckets[tenant] = (tokens - cost if ok else tokens, now)
        return ok


class EventValidator:
    """Schema gate for raw dict events (service boundary, DESIGN.md §12).

    An event is a JSON-able dict: a ``"type"`` string, optional scalar
    attributes, optional ``"timestamp"``.  ``allowed_types`` (when given)
    closes the type universe; ``monotone_attr`` names the clock attribute
    that must be present, finite, and non-decreasing across *accepted*
    events — the same invariant the device audit enforces, checked here
    so a bad clock becomes a dead-letter record instead of a mid-chunk
    engine exception.
    """

    def __init__(self, allowed_types: Optional[Sequence[str]] = None,
                 monotone_attr: Optional[str] = None):
        self.allowed_types = (None if allowed_types is None
                              else frozenset(allowed_types))
        self.monotone_attr = monotone_attr
        self._last_clock: Optional[float] = None

    def check(self, raw) -> Optional[str]:
        """Reason string when ``raw`` is rejected, else None (accepted)."""
        if not isinstance(raw, dict):
            return "not_a_dict"
        t = raw.get("type")
        if not isinstance(t, str) or not t:
            return "bad_type"
        if self.allowed_types is not None and t not in self.allowed_types:
            return "unknown_type"
        for k, v in raw.items():
            if not (v is None or isinstance(v, _SCALARS)):
                return "bad_attr_value"
        if self.monotone_attr is not None:
            v = raw.get(self.monotone_attr)
            if v is None or isinstance(v, bool) or \
                    not isinstance(v, (int, float)):
                return "missing_clock" if v is None else "bad_clock"
            v = float(v)
            if v != v or v in (float("inf"), float("-inf")):
                return "bad_clock"
            if self._last_clock is not None and v < self._last_clock:
                return "non_monotone_clock"
            self._last_clock = v
        return None


def _event_from_dict(raw: dict) -> Event:
    attrs = {k: v for k, v in raw.items()
             if k not in ("type", "timestamp")}
    return Event(raw["type"], attrs, timestamp=raw.get("timestamp"))


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return repr(v)


class DeadLetterQueue:
    """Replayable JSONL reject store with a durable sequence high-water.

    One record per reject: ``{"seq", "reason", "event"}``.  Mirrors the
    MatchLog's crash discipline — torn tail lines are truncated on open,
    and :meth:`append` drops records at or below the high-water mark, so
    a restarted producer replaying the stream re-rejects the same events
    without duplicating them.  (Validation rejects are deterministic
    under replay; backpressure sheds are timing-dependent and therefore
    at-least-once in the DLQ — replay tooling deduplicates by ``seq``.)
    """

    def __init__(self, path: str):
        self.path = path
        self._records: List[dict] = []
        self._repair()
        self._f = open(path, "a")
        self._high = max((r["seq"] for r in self._records), default=-1)

    def _repair(self) -> None:
        if not os.path.exists(self.path):
            return
        good_end = 0
        with open(self.path, "rb") as f:
            for line in f:
                if not line.endswith(b"\n"):
                    break
                try:
                    self._records.append(json.loads(line))
                except ValueError:
                    break
                good_end += len(line)
        if good_end < os.path.getsize(self.path):
            with open(self.path, "r+b") as f:
                f.truncate(good_end)

    def append(self, seq: int, reason: str, event) -> bool:
        """Record a reject; False when ``seq`` was already recorded."""
        if seq <= self._high:
            return False
        rec = {"seq": int(seq), "reason": reason, "event": _jsonable(event)}
        self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._f.flush()
        self._records.append(rec)
        self._high = int(seq)
        return True

    @property
    def records(self) -> List[dict]:
        return list(self._records)

    def high_water(self) -> int:
        return self._high

    def replay(self, submit: Callable[[dict], Any],
               transform: Optional[Callable[[dict], Any]] = None
               ) -> List[Any]:
        """Re-submit every dead-lettered event through ``submit`` (after
        an optional repair ``transform(record) -> event``); returns the
        receipts in record order."""
        out = []
        for rec in self._records:
            ev = transform(rec) if transform is not None else rec["event"]
            out.append(submit(ev))
        return out

    def close(self) -> None:
        self._f.close()


# ----------------------------------------------------------------------
# engine adapters: one raw-event chunk -> feed operands
# ----------------------------------------------------------------------
def _host_tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host tensor of ``arr``, pinned when the engine is on CUDA so the
    device thread's copy to the card is a plain DMA."""
    t = torch.from_numpy(arr)
    return t.pin_memory() if device.type == "cuda" else t


def _on_device(x, device: torch.device):
    """``x`` moved to ``device`` when it is a tensor; other operands pass.
    Issued on the calling (device) thread's current stream of ``device``,
    the stream the engine's feed launches on, so the copy is ordered
    before the feed's kernels; the pinned source stays referenced by the
    retained operands until the feed has synchronised."""
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    return x


class _PartitionedAdapter:
    """PartitionedStreamingEngine: encode keyed chunks on the host thread,
    feed them via ``feed_keyed`` on the device thread.

    The substream-local fallback clock and the hash-collision audit are
    adapter-owned (not the engine's): heal/recovery replays re-feed
    *retained encoded operands* without re-encoding, so the encode-side
    clock advances exactly once per stream event no matter how many times
    a chunk is device-replayed.
    """

    feed_method = "feed_keyed"
    supports_regrow = True

    def __init__(self, engine):
        self.engine = engine
        self.chunk_len = engine.chunk_len
        self._clock: Dict[int, int] = {}
        self._hash_to_key: Dict[int, tuple] = {}

    def encode(self, events: List[Event]):
        eng = self.engine
        audit_ts = True
        if eng.window.is_time:
            attrs, keys, ts = eng.encoder.encode_stream_keyed_ts(
                events, eng.key_attrs, eng.window.time_attr,
                clock=(self._clock if eng.window.time_attr is None
                       else None))
            if eng.window.time_attr is None and any(
                    ev.timestamp is None for ev in events
                    if partition_key(ev, eng.key_attrs) is not None):
                audit_ts = False
            kwargs = {"event_ts": _host_tensor(ts, eng.device),
                      "audit_ts": audit_ts}
        else:
            attrs, keys = eng.encoder.encode_stream_with_keys(
                events, eng.key_attrs)
            kwargs = {}
        for ev, h in zip(events, keys):
            key = partition_key(ev, eng.key_attrs)
            if key is None:
                continue
            prev = self._hash_to_key.setdefault(int(h), key)
            if prev != key:
                raise ValueError(
                    f"partition hash collision: {prev!r} and {key!r} both "
                    f"hash to {int(h):#x}; routing would merge their "
                    "substreams")
        # the key hashes travel as their int32 bits (the router's operand)
        return (_host_tensor(attrs, eng.device),
                _host_tensor(keys.view(np.int32), eng.device)), kwargs

    def pad_event(self) -> Event:
        # NULL partition key: the device router drops it before it can
        # touch any lane, so tail padding is behaviorally invisible
        return Event("__pad__", {})


class _SingleStreamAdapter:
    """StreamingVectorEngine at batch=1: one raw stream, ``feed_attrs``."""

    feed_method = "feed_attrs"
    supports_regrow = True

    def __init__(self, engine, pad_event: Optional[Event] = None):
        if engine.batch != 1:
            raise ValueError(
                f"StreamService feeds ONE raw stream; this engine has "
                f"batch={engine.batch} pre-partitioned lanes — use "
                "PartitionedStreamingEngine for interleaved keyed input")
        self.engine = engine
        self.chunk_len = engine.chunk_len
        self._pad = pad_event
        self._enc_pos = int(engine.position)   # encode-side stream cursor

    def encode(self, events: List[Event]):
        eng = self.engine
        if eng.window.is_time:
            attrs, ts = eng.encoder.encode_streams_ts(
                [events], eng.window.time_attr, base_pos=self._enc_pos)
            self._enc_pos += len(events)
            return ((_host_tensor(attrs, eng.device),),
                    {"event_ts": _host_tensor(ts, eng.device)})
        attrs = eng.encoder.encode_streams([events])
        self._enc_pos += len(events)
        return (_host_tensor(attrs, eng.device),), {}

    def pad_event(self) -> Event:
        if self._pad is None:
            raise ValueError(
                "drain(pad=True) on a single-stream engine needs an "
                "explicit pad_event= — unlike NULL-key partitioned pads, "
                "a single-stream pad occupies a position (it shifts count "
                "windows), so the service will not invent one")
        return self._pad


class _FleetAdapter:
    """QueryFleet at batch=1: the fleet encodes internally (its packing
    changes under churn), so 'encode' just shapes the stream; regrow is
    unsupported — run fleets with ``overflow_policy='raise'``."""

    feed_method = "feed"
    supports_regrow = False

    def __init__(self, engine):
        if engine.batch != 1:
            raise ValueError(
                f"StreamService feeds ONE raw stream; this fleet has "
                f"batch={engine.batch}")
        self.engine = engine
        self.chunk_len = engine.chunk_len

    def encode(self, events: List[Event]):
        return ([list(events)],), {}

    def pad_event(self) -> Event:
        raise ValueError("drain(pad=True) is unsupported for QueryFleet — "
                         "pass a full final chunk or drop the tail")


def _make_adapter(engine, pad_event: Optional[Event] = None):
    # late imports: runtime.service must not import the vector stack at
    # module load (runtime/__init__ is imported by host-only tooling)
    from ..vector.partitioned import PartitionedStreamingEngine
    from ..vector.streaming import StreamingVectorEngine
    from .fleet import QueryFleet
    if isinstance(engine, PartitionedStreamingEngine):
        return _PartitionedAdapter(engine)
    if isinstance(engine, StreamingVectorEngine):
        return _SingleStreamAdapter(engine, pad_event)
    if isinstance(engine, QueryFleet):
        return _FleetAdapter(engine)
    raise TypeError(f"no StreamService adapter for {type(engine).__name__}")


# ----------------------------------------------------------------------
# metrics
# ----------------------------------------------------------------------
@dataclass
class ServiceMetrics:
    accepted: int = 0
    rejected: int = 0
    shed_rate: int = 0
    shed_backpressure: int = 0
    block_timeouts: int = 0
    chunks: int = 0
    events_processed: int = 0
    alerts: int = 0
    replayed_chunks: int = 0
    skipped_chunks: int = 0
    overflows: int = 0
    regrows: int = 0
    queue_peak: int = 0
    chunk_latency_s: List[float] = field(default_factory=list)

    def latency_percentiles(self) -> Dict[str, float]:
        if not self.chunk_latency_s:
            return {"p50": 0.0, "p99": 0.0}
        lat = np.asarray(self.chunk_latency_s)
        return {"p50": float(np.percentile(lat, 50)),
                "p99": float(np.percentile(lat, 99))}


_STOP = object()


# ----------------------------------------------------------------------
# the service
# ----------------------------------------------------------------------
class StreamService:
    """Robust ingestion loop over a streaming engine (DESIGN.md §12).

    ::

        svc = StreamService(engine, directory, sinks=[on_alert],
                            validator=EventValidator(allowed_types={"TOK"}))
        for raw in source:           # raw dicts, one producer thread
            receipt = svc.submit(raw, block=True, timeout=1.0)
        svc.drain(pad=True)
        svc.close()

    Parameters
    ----------
    engine:
        A ``StreamingVectorEngine`` (batch=1), ``PartitionedStreamingEngine``
        or ``QueryFleet`` (batch=1).  The service owns it exclusively.
    directory:
        Recovery root: checkpoints + matches.log (the runner's), plus
        ``dead_letter.jsonl``, ``alerts.cursor`` and ``service_state.json``.
    sinks:
        Callables ``sink(chunk_index, hits)`` invoked for every chunk
        with ≥ 1 match, after its emission record is durable.  Delivery
        is at-least-once; ``chunk_index`` is the stable dedup key.
    admission:
        A :class:`TokenBucket` (or None to admit everything).  The tenant
        is ``raw.get(tenant_attr)``; events without the attribute share
        the ``None`` tenant bucket.
    overflow_policy:
        ``"regrow"`` (default): self-heal ``WindowOverflowError`` by ring
        regrow × ``growth_factor`` up to ``max_window_events_cap``, then
        replay.  Requires ``strict_overflow=True`` on the engine — the
        latch must be an error the service can catch, not a silent mode.
        ``"raise"``: surface the error to the producer.
    prune_roots:
        When True (default), enumeration roots below the emission
        high-water mark are dropped (``engine.clear_roots(before=…)``)
        right after each chunk's alerts are durably delivered, so the
        host-side ``_roots`` dict stays bounded by in-flight work
        instead of growing one entry per hit for the life of the
        stream.  Sinks run *before* the prune, so enumerating inside a
        sink callback always works; pass ``prune_roots=False`` if you
        need to enumerate delivered hits after the run.
    """

    def __init__(self, engine, directory: str, *,
                 sinks: Sequence[Callable[[int, list], None]] = (),
                 validator: Optional[EventValidator] = None,
                 admission: Optional[TokenBucket] = None,
                 tenant_attr: Optional[str] = None,
                 chunk_len: Optional[int] = None,
                 queue_chunks: int = 8,
                 pipeline_depth: int = 2,
                 checkpoint_every: int = 8,
                 keep: int = 3,
                 policy: Optional[RetryPolicy] = None,
                 overflow_policy: str = "regrow",
                 growth_factor: int = 2,
                 max_window_events_cap: int = 1 << 16,
                 pad_event: Optional[Event] = None,
                 prune_roots: bool = True):
        if overflow_policy not in ("regrow", "raise"):
            raise ValueError(f"overflow_policy must be 'regrow' or 'raise', "
                             f"got {overflow_policy!r}")
        self.adapter = _make_adapter(engine, pad_event)
        self.engine = engine
        self.chunk_len = int(chunk_len if chunk_len is not None
                             else self.adapter.chunk_len)
        if self.chunk_len != self.adapter.chunk_len:
            raise ValueError(
                f"chunk_len={self.chunk_len} does not match the engine's "
                f"compiled chunk_len={self.adapter.chunk_len}")
        self.overflow_policy = overflow_policy
        if overflow_policy == "regrow":
            if not self.adapter.supports_regrow:
                self.overflow_policy = "raise"
            elif engine.window.is_time and not engine.strict_overflow:
                raise ValueError(
                    "overflow_policy='regrow' needs strict_overflow=True "
                    "on the engine: the ovf latch must raise "
                    "WindowOverflowError for the service to catch and heal")
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.validator = validator if validator is not None \
            else EventValidator()
        self.admission = admission
        self.tenant_attr = tenant_attr
        self.queue_chunks = int(queue_chunks)
        self.growth_factor = int(growth_factor)
        self.max_window_events_cap = int(max_window_events_cap)
        self.sinks = list(sinks)
        self.prune_roots = bool(prune_roots)
        self.metrics = ServiceMetrics()
        self.dlq = DeadLetterQueue(
            os.path.join(directory, "dead_letter.jsonl"))
        self.runner = RecoveringStreamRunner(
            engine, directory, every=checkpoint_every, keep=keep,
            policy=policy, feed_method=self.adapter.feed_method,
            blocking_saves=False)
        self._cursor_path = os.path.join(directory, "alerts.cursor")
        self._sidecar_path = os.path.join(directory, "service_state.json")
        self._event_seq = -1              # last assigned event sequence
        self._pending: List[Event] = []   # current partial chunk
        self._chunk_seq = 0               # next chunk index to form
        self._buffered = 0                # accepted events not yet stepped
        self._retained: Dict[int, tuple] = {}   # seq -> (args, kwargs)
        self._lock = threading.Lock()
        self._space = threading.Condition(self._lock)
        self._error: Optional[BaseException] = None
        self._raw_q: "queue.Queue" = queue.Queue()
        self._enc_q: "queue.Queue" = queue.Queue(maxsize=int(pipeline_depth))
        self._closed = False
        w = getattr(engine, "window", None)     # QueryFleet has no window
        self._mwe = int(w.ring) if w is not None else 0
        # current rate bound (the padded ring)
        self._resume()
        self._enc_thread = threading.Thread(
            target=self._encode_loop, name="svc-encode", daemon=True)
        self._dev_thread = threading.Thread(
            target=self._device_loop, name="svc-device", daemon=True)
        self._enc_thread.start()
        self._dev_thread.start()

    # -- restart path ---------------------------------------------------
    def _read_sidecar(self) -> dict:
        try:
            with open(self._sidecar_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _write_sidecar(self, max_window_events: int,
                       quarantined: Sequence[int]) -> None:
        tmp = self._sidecar_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"max_window_events": int(max_window_events),
                       "quarantined": [int(b) for b in quarantined]}, f)
        os.replace(tmp, self._sidecar_path)

    def _resume(self) -> None:
        """Restore the newest checkpoint and finish any interrupted heal.

        The regrow target is the max over (a) the sidecar's recorded
        bound (written before the heal's restore, so a crash at any point
        inside the heal still finds it), (b) the checkpoint manifest's
        own ring, and (c) ring × growth when either source says lanes
        were quarantined — the crash happened before the healed state
        checkpointed, so the overflow would otherwise just re-raise
        during replay."""
        side = self._read_sidecar()
        target = int(side.get("max_window_events", 0))
        mid_heal = bool(side.get("quarantined"))
        meta = self.runner.latest_manifest()
        if meta is not None:
            ring = int((meta.get("window") or {}).get("ring", self._mwe))
            target = max(target, ring)
            if meta.get("quarantined_lanes") or mid_heal:
                target = max(target, ring * self.growth_factor)
            kw = {}
            if self.adapter.supports_regrow and \
                    _pad8(target) > self.engine.window.ring:
                kw["max_window_events"] = target
            self.runner.resume(**kw)
            # QueryFleet has no quarantine surface (supports_regrow=False)
            if self.adapter.supports_regrow and \
                    getattr(self.engine, "quarantined_lanes", ()):
                self.engine.clear_quarantine()   # ring is regrown: healed
        elif self.adapter.supports_regrow and \
                _pad8(max(target, 1)) > self.engine.window.ring:
            self.engine.regrow(target)
        if self.adapter.supports_regrow:
            self._mwe = int(self.engine.window.ring)
        # Producer contract after a restart: resubmit the stream FROM THE
        # BEGINNING (at-least-once ingestion).  Chunk numbering therefore
        # restarts at 0 — chunks the restored checkpoint already contains
        # are skipped on the device thread (their encode still runs, so
        # the adapter's stream clock advances exactly as in the original
        # run and replayed chunks encode bit-identically), chunks between
        # the checkpoint and the emission log's high-water mark replay
        # with emission suppressed, and everything after is new work.
        self._chunk_seq = 0
        # Replayed chunks must recompose exactly or _check_replay refuses
        # them, so admission decisions cannot be re-made live (a refilled
        # token bucket or different queue timing would admit an event the
        # original run shed, shifting every later chunk).  Sheds recorded
        # in the DLQ replay verbatim by seq; while forming chunks at or
        # below the emission high-water mark, live shedding is bypassed.
        self._replay_chunk_high = self.runner.log.high_water()
        self._replayed_sheds = {
            int(r["seq"]): r["reason"] for r in self.dlq.records
            if r["reason"] in ("shed_rate", "shed_backpressure")}
        if target or mid_heal:
            self._write_sidecar(self._mwe, ())
        self._redeliver_alerts()

    def _read_cursor(self) -> int:
        try:
            with open(self._cursor_path) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return -1

    def _advance_cursor(self, chunk: int) -> None:
        tmp = self._cursor_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(int(chunk)))
        os.replace(tmp, self._cursor_path)

    def _redeliver_alerts(self) -> None:
        """At-least-once alert recovery: every durable emission record
        above the cursor goes to the sinks again (the crash may have hit
        between log append and delivery)."""
        cursor = self._read_cursor()
        top = cursor
        for rec in self.runner.log.records:
            if rec["chunk"] > cursor and rec["hits"]:
                self._deliver(rec["chunk"], rec["hits"])
            top = max(top, rec["chunk"])
        if top > cursor:
            self._advance_cursor(top)
        if top >= 0:
            self._prune_roots(top)

    def _deliver(self, chunk: int, hits) -> None:
        hits = [_hit_key(h) for h in hits]
        for sink in self.sinks:
            sink(chunk, hits)
        self.metrics.alerts += len(hits)

    def _prune_roots(self, chunk: int) -> None:
        """Drop enumeration roots below the emission high-water mark.

        Chunk ``chunk`` covers stream positions < ``(chunk + 1) *
        chunk_len`` and its alerts are durable and delivered, so no
        earlier root can ever be hit again — roots are keyed by a
        match's END position, and every future hit records a fresh
        entry at its own (later) position.  Replay-suppressed chunks
        below the mark are covered too: their hits were delivered in
        the pre-crash run.  Host-side bookkeeping only; arena nodes on
        device are untouched."""
        if self.prune_roots:
            self.engine.clear_roots(before=(chunk + 1) * self.chunk_len)

    # -- producer side --------------------------------------------------
    def _check_error(self) -> None:
        if self._error is not None:
            raise StreamServiceError(
                f"service worker failed: {self._error!r}") from self._error

    @property
    def _capacity(self) -> int:
        return self.queue_chunks * self.chunk_len

    def submit(self, raw, *, block: bool = False,
               timeout: Optional[float] = None) -> Receipt:
        """Offer one raw dict event; never raises on bad input.

        Non-blocking by default: a full ingress buffer sheds the event to
        the DLQ (``shed_backpressure``).  ``block=True`` waits for space
        up to ``timeout`` seconds (None = forever) and returns a
        ``timeout`` receipt on deadline — the event is NOT dead-lettered:
        the producer still holds it and decides.
        """
        self._check_error()
        if self._closed:
            raise StreamServiceError("submit() after close()")
        self._event_seq += 1
        seq = self._event_seq
        reason = self.validator.check(raw)
        if reason is not None:
            self.dlq.append(seq, reason, raw)
            self.metrics.rejected += 1
            return Receipt("rejected", seq, reason)
        shed = self._replayed_sheds.get(seq)
        if shed is not None:
            # producer replay: this seq was dead-lettered as a shed in the
            # original run, so the decision replays verbatim — admitting
            # it now would shift the composition of every later chunk
            # (the DLQ record already exists; append dedups by seq)
            if shed == "shed_rate":
                self.metrics.shed_rate += 1
            else:
                self.metrics.shed_backpressure += 1
            return Receipt(shed, seq)
        replaying = self._chunk_seq <= self._replay_chunk_high
        if self.admission is not None:
            ok = self.admission.allow(
                raw.get(self.tenant_attr) if self.tenant_attr else None)
            # while replaying, allow() still charges the bucket (so its
            # state warms as in the original run) but cannot shed: the
            # event was accepted originally and the replayed chunk must
            # contain it
            if not ok and not replaying:
                self.dlq.append(seq, "shed_rate", raw)
                self.metrics.shed_rate += 1
                return Receipt("shed_rate", seq)
        with self._space:
            if self._buffered + 1 > self._capacity:
                if replaying:
                    # replay accepts exactly the originally-accepted
                    # events — a full buffer blocks (the device thread is
                    # skipping/replaying ahead of us), it never sheds
                    while self._buffered + 1 > self._capacity and \
                            self._error is None:
                        self._space.wait(0.5)
                elif not block:
                    self.dlq.append(seq, "shed_backpressure", raw)
                    self.metrics.shed_backpressure += 1
                    return Receipt("shed_backpressure", seq)
                else:
                    deadline = (None if timeout is None
                                else time.monotonic() + timeout)
                    while self._buffered + 1 > self._capacity:
                        left = (None if deadline is None
                                else deadline - time.monotonic())
                        if left is not None and left <= 0:
                            self.metrics.block_timeouts += 1
                            return Receipt("timeout", seq)
                        self._space.wait(left)
                        if self._error is not None:
                            break
            if self._error is None:     # a worker died while we waited:
                self._buffered += 1     # don't count the event in, the
                self.metrics.queue_peak = max(    # producer still owns it
                    self.metrics.queue_peak, self._buffered)
        self._check_error()
        self.metrics.accepted += 1
        self._pending.append(_event_from_dict(raw))
        if len(self._pending) == self.chunk_len:
            self._flush_pending(n_real=self.chunk_len)
        return Receipt("accepted", seq)

    def _flush_pending(self, n_real: int) -> None:
        chunk, self._pending = self._pending, []
        self._raw_q.put((self._chunk_seq, chunk, n_real,
                         time.perf_counter()))
        self._chunk_seq += 1

    def drain(self, *, pad: bool = False, timeout: float = 60.0) -> None:
        """Block until every accepted event has been device-stepped.

        A partial tail chunk only flushes with ``pad=True`` (the adapter
        supplies inert pad events; for partitioned engines they carry a
        NULL key and never touch a lane).  Without padding the tail stays
        pending for the next submits.
        """
        self._check_error()
        if self._pending and pad:
            n_real = len(self._pending)
            self._pending.extend(
                self.adapter.pad_event()
                for _ in range(self.chunk_len - n_real))
            self._flush_pending(n_real=n_real)
        # an unflushed tail never reaches the device, so only wait for
        # the flushed chunks (buffered events beyond the pending tail)
        tail = len(self._pending)
        deadline = time.monotonic() + timeout
        with self._space:
            while self._buffered > tail:
                if self._error is not None:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    raise StreamServiceError(
                        f"drain timed out after {timeout}s with "
                        f"{self._buffered - tail} flushed events still "
                        "in flight")
                self._space.wait(min(left, 0.5))
        self._check_error()

    def close(self, *, checkpoint: bool = True) -> None:
        """Stop the workers, take a final checkpoint, release files."""
        if self._closed:
            return
        self._closed = True
        self._raw_q.put(_STOP)
        self._enc_thread.join()
        self._dev_thread.join()
        if checkpoint and self._error is None:
            self.runner.checkpoint()
        self.runner.close()
        self.dlq.close()

    # -- worker threads -------------------------------------------------
    def _encode_loop(self) -> None:
        try:
            while True:
                item = self._raw_q.get()
                if item is _STOP:
                    self._enc_q.put(_STOP)
                    return
                seq, events, n_real, t0 = item
                args, kwargs = self.adapter.encode(events)
                self._enc_q.put((seq, args, kwargs, n_real, t0))
        except BaseException as e:   # noqa: BLE001 — surfaced to producer
            self._error = e
            self._enc_q.put(_STOP)
            with self._space:
                self._space.notify_all()

    def _device_loop(self) -> None:
        try:
            while True:
                item = self._enc_q.get()
                if item is _STOP:
                    return
                seq, args, kwargs, n_real, t0 = item
                if seq < self.runner.chunk_index:
                    # the restored checkpoint already contains this chunk
                    self.metrics.skipped_chunks += 1
                    self._release(n_real)
                    continue
                try:
                    counts, hits, emitted = self._process(args, kwargs)
                except WindowOverflowError as e:
                    if self.overflow_policy != "regrow":
                        raise
                    counts, hits, emitted = self._heal_overflow(
                        e, seq, args, kwargs)
                self._retained[seq] = (args, kwargs)
                self._prune_retained()
                self.metrics.chunks += 1
                self.metrics.events_processed += n_real
                if not emitted:
                    self.metrics.replayed_chunks += 1
                elif hits:
                    self._deliver(seq, hits)
                    self._advance_cursor(seq)
                    self._prune_roots(seq)
                self.metrics.chunk_latency_s.append(
                    time.perf_counter() - t0)
                self._release(n_real)
        except BaseException as e:   # noqa: BLE001 — surfaced to producer
            self._error = e
            with self._space:
                self._space.notify_all()
            while True:     # keep draining: unblock the encoder's bounded
                if self._enc_q.get() is _STOP:   # put so close() can join
                    return

    def _process(self, args, kwargs):
        """One runner step over host operands: copied to the engine's
        device here, on the device thread (retained operands stay on the
        host, so replays after a heal copy them again)."""
        dev = self.engine.device
        return self.runner.process(
            *(_on_device(a, dev) for a in args),
            **{k: _on_device(v, dev) for k, v in kwargs.items()})

    def _release(self, n_real: int) -> None:
        with self._space:
            self._buffered -= n_real
            self._space.notify_all()

    def _prune_retained(self) -> None:
        """Drop retained operands older than the newest *durable*
        checkpoint — a heal restores that checkpoint and replays forward,
        so nothing earlier can ever be re-fed."""
        latest = self.runner.manager.latest_step()
        if latest is None:
            return
        for s in [s for s in self._retained if s < latest]:
            del self._retained[s]

    # -- overflow self-healing ------------------------------------------
    def _heal_overflow(self, err: WindowOverflowError, seq: int,
                       args, kwargs):
        """Quarantine → regrow → replay → re-feed (DESIGN.md §12).

        The overflow left the latched lanes' state corrupt (the chunk was
        applied before the latch was checked), so healing NEVER migrates
        the post-overflow state: it restores the last pre-overflow
        checkpoint onto the regrown ring (or resets, when no checkpoint
        exists yet) and replays the retained chunks, whose re-emissions
        the high-water mark suppresses.  The offending chunk then feeds
        on the wider ring; if it *still* overflows, the bound doubles
        again up to ``max_window_events_cap``.
        """
        self.metrics.overflows += 1
        lanes = [int(b) for b in np.atleast_1d(err.lanes)]
        self.engine.quarantine(lanes)
        target = self._mwe
        while True:
            if target >= self.max_window_events_cap and \
                    _pad8(target) <= self.engine.window.ring:
                raise StreamServiceError(
                    f"overflow heal exhausted: chunk {seq} still overflows "
                    f"at the max_window_events_cap="
                    f"{self.max_window_events_cap} bound (lanes {lanes})")
            target = min(target * self.growth_factor,
                         self.max_window_events_cap)
            # durable intent BEFORE any state change: a crash anywhere in
            # the heal finds the bound (and the parked lanes) on restart
            self._write_sidecar(target, self.engine.quarantined_lanes)
            if self.runner.manager.latest_step() is not None:
                self.runner.resume(max_window_events=target)
            else:
                self.engine.reset()
                self.engine.regrow(target)
                self.runner.rewind(0)
            self.metrics.regrows += 1
            self._mwe = int(self.engine.window.ring)
            self.engine.clear_quarantine()
            try:
                for s in sorted(self._retained):
                    if self.runner.chunk_index <= s < seq:
                        r_args, r_kwargs = self._retained[s]
                        counts, hits, emitted = self._process(r_args,
                                                              r_kwargs)
                        if not emitted:
                            self.metrics.replayed_chunks += 1
                result = self._process(args, kwargs)
            except WindowOverflowError as e2:
                self.engine.quarantine([int(b)
                                        for b in np.atleast_1d(e2.lanes)])
                continue
            self._write_sidecar(self._mwe, ())
            return result


__all__ = ["StreamService", "StreamServiceError", "Receipt", "TokenBucket",
           "EventValidator", "DeadLetterQueue", "ServiceMetrics"]
