"""Crash-only streaming: checkpointed engine state + exactly-once replay.

DESIGN.md §10.  The streaming engines carry their whole evaluation state in
device buffers updated in place, and :meth:`snapshot`/:meth:`restore`
round-trip it bit-exactly (in the reference package's layout) — so a
crashed stream processor does NOT replay from t=0 (the super-linear cost
CORE's tECS exists to avoid): it restores the last checkpoint and re-feeds
only the chunks since.

Two durable artifacts live under the recovery directory:

``ckpt/step_<k>/``
    Atomic engine snapshots through :class:`repro_torch.checkpoint.
    CheckpointManager` (tmp-dir + rename: a torn writer never leaves a
    readable-but-corrupt step).  ``extra`` carries the engine's
    restore-compatibility manifest plus the stream cursor ``chunk``.

``matches.log``
    The **emission record**: an append-only JSONL file with one record per
    fed chunk (match counts in sparse form + hit positions).  Its highest
    chunk index is the durable high-water mark.  Exactly-once emission
    falls out of two rules:

    1. *log before checkpoint* — a chunk's record is appended (and
       flushed) before any checkpoint covering it publishes, so a restart
       can never re-feed a chunk the log has never seen while believing it
       already emitted it;
    2. *suppress below the mark* — on replay, chunks with index ≤ the
       high-water mark recompute bit-identical results (restore is
       bit-exact and the kernels are deterministic) but are NOT
       re-appended.

    A torn tail line (kill -9 mid-write) is detected on open and truncated
    away — that chunk simply replays.  ``flush()`` is enough for the
    process-crash threat model (kill -9 loses the process, not the OS page
    cache); full-machine durability would add ``os.fsync``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..checkpoint.manager import CheckpointManager
from ..kernels.window import WindowOverflowError
from .fault_tolerance import HeartbeatMonitor, RetryPolicy, run_with_retries

#: default step policy: transient RuntimeError/OSError back off and
#: retry; the deny-list names the state-problem signals a retry can only
#: repeat — the overflow latch survives the retry (and the chunk was
#: already applied, so re-feeding corrupts state), and a compat-manifest
#: ValueError means the engine and snapshot disagree structurally.  A
#: per-attempt timeout (``timeout_s``) is crash-only: the abandoned
#: attempt may still be writing the engine's state buffers, so an
#: in-process re-feed could apply the chunk twice — recovery is restart +
#: restore.
DEFAULT_STEP_POLICY = RetryPolicy(
    non_retryable=(WindowOverflowError, ValueError))


def _hit_key(h):
    """JSON round-trip normalization: lists → tuples, ints stay ints."""
    return tuple(h) if isinstance(h, (list, tuple)) else int(h)


class MatchLog:
    """Append-only JSONL emission record with a durable high-water mark."""

    def __init__(self, path: str):
        self.path = path
        self._records: List[Dict[str, Any]] = []
        self._repair()
        self._f = open(path, "a")

    # -- recovery scan -------------------------------------------------
    def _repair(self) -> None:
        """Load every intact record; truncate a torn tail line in place."""
        if not os.path.exists(self.path):
            return
        good_end = 0
        with open(self.path, "rb") as f:
            for line in f:
                if not line.endswith(b"\n"):
                    break                      # torn tail: crash mid-write
                try:
                    self._records.append(json.loads(line))
                except ValueError:
                    break                      # torn earlier than the tail?
                good_end += len(line)
        if good_end < os.path.getsize(self.path):
            with open(self.path, "r+b") as f:
                f.truncate(good_end)

    # -- append path ---------------------------------------------------
    def append(self, chunk: int, counts: np.ndarray, hits) -> None:
        counts = np.asarray(counts)
        nz = np.nonzero(counts)
        # bulk .tolist() keeps this off the feed hot path (the per-element
        # zip/int() loop cost ~15% of a chunk feed at bench chunk sizes)
        idxs = np.stack(nz, axis=-1).tolist()
        rec = {
            "chunk": int(chunk),
            "shape": list(counts.shape),
            "counts": [list(p) for p in zip(idxs, counts[nz].tolist())],
            "hits": [list(h) if isinstance(h, tuple) else int(h)
                     for h in hits],
        }
        self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._f.flush()
        self._records.append(rec)

    def close(self) -> None:
        self._f.close()

    # -- reads ---------------------------------------------------------
    @property
    def records(self) -> List[Dict[str, Any]]:
        return list(self._records)

    def high_water(self) -> int:
        """Highest chunk index durably emitted; -1 for an empty log."""
        return max((r["chunk"] for r in self._records), default=-1)

    def cumulative(self) -> Dict[str, Any]:
        """The cumulative emitted match set, in comparable form.

        ``hits``: sorted list of every emitted hit (ints or ``(pos,
        stream)`` tuples); ``counts``: ``{(chunk, *index): value}`` over
        all nonzero count cells.  Two runs emitted the same matches iff
        these compare equal.
        """
        hits = set()
        counts: Dict[tuple, int] = {}
        for r in self._records:
            hits.update(_hit_key(h) for h in r["hits"])
            for idx, v in r["counts"]:
                counts[(r["chunk"], *idx)] = v
        # total order over int and (pos, stream) hit keys alike
        order = lambda h: (1, h) if isinstance(h, tuple) else (0, (h,))
        return {"hits": sorted(hits, key=order), "counts": counts}


def cumulative_matches(directory: str) -> Dict[str, Any]:
    """Read a recovery directory's cumulative emitted match set (the
    restart-invariant artifact the crash tests compare)."""
    log = MatchLog(os.path.join(directory, "matches.log"))
    try:
        return log.cumulative()
    finally:
        log.close()


class RecoveringStreamRunner:
    """Drive a streaming engine crash-only: retries, heartbeat, periodic
    checkpoints, and exactly-once emission across kill -9 restarts.

    ::

        runner = RecoveringStreamRunner(engine, directory, every=8)
        runner.resume()                  # no-op on a fresh directory
        for chunk in chunks[runner.chunk_index:]:
            counts, hits, emitted = runner.process(chunk)
        runner.close()

    ``process`` feeds one chunk under ``run_with_retries`` with
    :data:`DEFAULT_STEP_POLICY` (transient ``RuntimeError``/``OSError``
    back off with jittered exponential delays and retry; the explicit
    ``non_retryable`` deny-list — :class:`~repro_torch.kernels.window.
    WindowOverflowError`, compat-manifest ``ValueError`` — propagates
    immediately: the latch survives the retry, and re-feeding would
    corrupt state), beats the heartbeat, appends the emission record, and
    checkpoints every ``every`` chunks.  Snapshots are host-side copies
    taken *between* feeds — the in-place state buffers and
    ``compile_count == 1`` are untouched.

    After :meth:`resume`, re-feed the stream from ``chunk_index`` (the
    checkpoint's cursor).  Chunks the log already recorded replay with
    ``emitted=False``; their recomputed results are asserted bit-identical
    to the durable record — a divergence means the input replay differs
    from the original stream, which exactly-once cannot survive, so it
    raises instead of silently double- or mis-emitting.
    """

    def __init__(self, engine, directory: str, *, every: int = 8,
                 keep: int = 3, policy: Optional[RetryPolicy] = None,
                 heartbeat_timeout: Optional[float] = None,
                 feed_method: str = "feed", blocking_saves: bool = True):
        if every < 1:
            raise ValueError(f"checkpoint interval must be ≥ 1, got {every}")
        self.engine = engine
        self.directory = directory
        self.every = int(every)
        self.policy = (policy if policy is not None
                       else DEFAULT_STEP_POLICY)
        self.feed_method = feed_method
        self.blocking_saves = blocking_saves
        os.makedirs(directory, exist_ok=True)
        self.manager = CheckpointManager(
            os.path.join(directory, "ckpt"), keep=keep)
        self.log = MatchLog(os.path.join(directory, "matches.log"))
        self.monitor = (HeartbeatMonitor(timeout_s=heartbeat_timeout).start()
                        if heartbeat_timeout is not None else None)
        #: index of the next chunk to feed (== chunks fed so far)
        self.chunk_index = 0
        self._replay_through = self.log.high_water()
        # one-step read cache so latest_manifest() + resume() on a restart
        # load the checkpoint arrays from disk once, not twice
        self._loaded: Optional[Tuple[int, Any, dict]] = None

    # ------------------------------------------------------------------
    @property
    def replaying(self) -> bool:
        """True while re-fed chunks are suppressed by the high-water mark."""
        return self.chunk_index <= self._replay_through

    def resume(self, **restore_kwargs) -> bool:
        """Restore the newest checkpoint, if any.  Returns True when one
        was restored; ``chunk_index`` then points at the first chunk to
        re-feed (everything before it is inside the restored state).

        Keyword arguments forward to ``engine.restore`` — the elastic
        restore paths (``n_lanes=…``, ``migrate_packing=True``,
        ``max_window_events=…``) compose with crash recovery, e.g. the
        service's overflow heal resumes the last good checkpoint directly
        onto a regrown ring."""
        loaded = self._load_latest()
        if loaded is None:
            return False
        _, arrays, meta = loaded
        self._loaded = None    # hand the arrays to restore, don't hold them
        self.engine.restore({"arrays": arrays, "meta": meta},
                            **restore_kwargs)
        self.chunk_index = int(meta["chunk"])
        self._replay_through = self.log.high_water()
        return True

    def _load_latest(self) -> Optional[Tuple[int, Any, dict]]:
        while True:
            step = self.manager.latest_step()
            if step is None:
                self._loaded = None
                return None
            if self._loaded is not None and self._loaded[0] == step:
                return self._loaded
            try:
                arrays, meta = self.manager.load_arrays(step)
            except FileNotFoundError:
                # an async write published a newer step and collected
                # this one between the two calls: read the newer one
                if self.manager.latest_step() != step:
                    continue
                raise
            self._loaded = (step, arrays, meta)
            return self._loaded

    def latest_manifest(self) -> Optional[dict]:
        """The newest checkpoint's manifest (``extra``), or None on a
        fresh directory — read without touching engine state, so a
        restarting service can size a ring regrow before restoring.  The
        loaded arrays are cached so a :meth:`resume` that follows reuses
        them instead of re-reading the checkpoint from disk."""
        loaded = self._load_latest()
        return None if loaded is None else loaded[2]

    def rewind(self, chunk_index: int = 0) -> None:
        """Reset the stream cursor without touching checkpoints or the
        emission log — for drivers that rebuild engine state outside the
        checkpoint path (e.g. an overflow heal with no checkpoint yet:
        ``engine.reset(); engine.regrow(…)``) and then replay the input
        from ``chunk_index``.  The high-water mark still suppresses
        re-emission of everything already durably recorded."""
        self.chunk_index = int(chunk_index)
        self._replay_through = self.log.high_water()

    def process(self, *args, **kwargs) -> Tuple[np.ndarray, list, bool]:
        """Feed one chunk; returns ``(counts, hits, emitted)``.

        ``emitted`` is False when the chunk was already durably recorded
        before a crash (exactly-once suppression).
        """
        idx = self.chunk_index
        feed = getattr(self.engine, self.feed_method)
        counts, hits = run_with_retries(feed, self.policy, *args, **kwargs)
        if self.monitor is not None:
            self.monitor.beat()
        self.chunk_index = idx + 1
        if idx <= self._replay_through:
            self._check_replay(idx, counts, hits)
            emitted = False
        else:
            self.log.append(idx, counts, hits)
            emitted = True
        if self.chunk_index % self.every == 0:
            self.checkpoint()
        return counts, hits, emitted

    def _check_replay(self, idx: int, counts, hits) -> None:
        rec = next((r for r in self.log.records if r["chunk"] == idx), None)
        if rec is None:      # below the mark but compacted away: accept
            return
        counts = np.asarray(counts)
        nz = np.nonzero(counts)
        got = {tuple(map(int, i)): int(v) for *i, v in zip(*nz, counts[nz])}
        want = {tuple(i): v for i, v in rec["counts"]}
        if got != want or [_hit_key(h) for h in hits] != \
                [_hit_key(h) for h in rec["hits"]]:
            raise ValueError(
                f"replayed chunk {idx} diverged from its durable emission "
                "record — the replayed input does not match the original "
                "stream; exactly-once delivery cannot be preserved")

    def checkpoint(self) -> None:
        """Snapshot the engine now (log-before-checkpoint ordering: every
        record covering the snapshot is already flushed)."""
        snap = self.engine.snapshot()
        extra = dict(snap["meta"], chunk=self.chunk_index)
        self.manager.save(self.chunk_index, snap["arrays"],
                          blocking=self.blocking_saves, extra=extra)

    def close(self) -> None:
        if self.monitor is not None:
            self.monitor.stop()
        self.manager.wait()
        self.log.close()
