"""Fault-tolerant training loop (crash-only design), the reference's
``runtime/trainer.py`` on PyTorch.

The Trainer wires together the deterministic data pipeline (resume =
replay by step index), the checkpoint manager (atomic, async), the retry
policy (transient failures retried, persistent ones restored from the
last checkpoint), the heartbeat watchdog and straggler timing.  Each
step's scalar metrics become one ``STEP`` event for every monitor (a CORE
executor), so CEQL queries run as training monitors.

A train state ``{"params": Stack, "opt", "err"?}`` (``models.steps``) is
checkpointed in the reference's tree (:func:`~repro_torch.models.steps.
state_tree`), so the reference can restore it, and read back into the
live tensors; any other state is saved as the tree it is and replaced by
the restored tree.  The step writes the state in place, so a retried
failure must come before the step touches it (as an injected or a
data-side failure does).  A step's time includes reading its metrics to
the host, which waits for the device.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

from ..checkpoint import CheckpointManager
from ..core.events import Event
from .fault_tolerance import (HeartbeatMonitor, RetryPolicy, StepTimer,
                              run_with_retries)


@dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    heartbeat_timeout_s: float = 600.0
    max_restores: int = 2


def _is_train_state(state: Any) -> bool:
    from ..models.stack import Stack
    return isinstance(state, dict) and isinstance(state.get("params"), Stack)


def _writes_checkpoints() -> bool:
    """Rank 0 of a process group writes the checkpoints; a process outside
    one writes its own."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _on_host(t):
    """A tensor's whole value; a DTensor's gathered (a collective) and
    copied to the host, so that the card holds one whole leaf at a
    time."""
    from ..sharding import full, is_dtensor
    return full(t.detach()).cpu() if is_dtensor(t) else t.detach()


def _shape_of(t):
    """A tensor's global shape and dtype, on ``meta``."""
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _gathered_only(t):
    """A DTensor gathered (a collective) but not kept: another rank
    writes it."""
    from ..sharding import full
    return _shape_of(full(t.detach()))


class Trainer:
    def __init__(self, step_fn: Callable, state: Any, data: Any,
                 cfg: TrainerConfig,
                 monitors: Optional[List] = None,
                 retry: Optional[RetryPolicy] = None):
        self.step_fn = step_fn
        self.state = state
        self.data = data
        self.cfg = cfg
        self.ckpt = CheckpointManager(cfg.checkpoint_dir,
                                      keep=cfg.keep_checkpoints)
        self.retry = retry or RetryPolicy()
        self.timer = StepTimer()
        self.monitors = monitors or []   # CER executors over metric events
        self.metrics_log: List[Dict] = []
        self.matches: List = []
        self.restores = 0

    # ------------------------------------------------------------------
    def _tree(self, leaf=None) -> Any:
        """What a checkpoint holds: the reference's tree of a train state
        (each tensor through ``leaf``, :func:`~repro_torch.models.steps.
        state_tree`), else the state itself."""
        if _is_train_state(self.state):
            from ..models.steps import state_tree
            return state_tree(self.state, self.state["params"].cfg, leaf)
        return self.state

    def _emit_metrics_event(self, step: int, metrics: Dict) -> None:
        ev = Event("STEP", dict(metrics), position=step,
                   timestamp=float(step))
        for mon in self.monitors:
            for ce in mon.process(ev):
                self.matches.append((step, ce))

    def _restore(self, start_step: int) -> int:
        latest = self.ckpt.latest_step()
        if latest is None:
            return start_step
        tree, extra = self.ckpt.restore(self._tree(_shape_of))
        if _is_train_state(self.state):
            from ..models.steps import load_state_tree
            load_state_tree(self.state, tree, self.state["params"].cfg)
        else:
            self.state = tree
        return int(extra.get("next_step", latest + 1))

    def _save(self, step: int, blocking: bool) -> None:
        # a sharded state's tensors are gathered whole one at a time, every
        # rank taking part; rank 0 copies each to the host and writes them
        if _writes_checkpoints():
            self.ckpt.save(step, self._tree(_on_host), blocking=blocking,
                           extra={"next_step": step})
        else:
            self._tree(_gathered_only)

    # ------------------------------------------------------------------
    def run(self, start_step: int = 0, resume: bool = False) -> Dict:
        step = self._restore(start_step) if resume else start_step
        hb = HeartbeatMonitor(timeout_s=self.cfg.heartbeat_timeout_s).start()
        try:
            while step < self.cfg.total_steps:
                batch = self.data.batch_at(step)
                try:
                    with self.timer:
                        self.state, metrics = run_with_retries(
                            self.step_fn, self.retry, self.state, batch)
                        metrics = {k: float(v) for k, v in metrics.items()}
                except self.retry.retryable:
                    # persistent failure: crash-only restart from checkpoint
                    if self.restores >= self.cfg.max_restores:
                        raise
                    self.restores += 1
                    step = self._restore(step)
                    continue
                self.metrics_log.append({"step": step, **metrics})
                self._emit_metrics_event(step, metrics)
                hb.beat()
                step += 1
                if step % self.cfg.checkpoint_every == 0:
                    self._save(step, blocking=not self.cfg.async_checkpoint)
            self._save(self.cfg.total_steps, blocking=True)
        finally:
            hb.stop()
            self.ckpt.wait()
        return {"final_step": step,
                "median_step_time": self.timer.median,
                "stragglers": list(self.timer.stragglers),
                "restores": self.restores,
                "monitor_matches": len(self.matches)}
