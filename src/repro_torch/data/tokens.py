"""Deterministic synthetic token pipeline with shardable, resumable state,
the reference's ``data/tokens.py`` on PyTorch.

A batch is a function of ``(seed, step, shard index)`` alone, so any
process can make its own shard of any step without coordination, and a
restart at step k replays exactly the batches a failed run would have
seen.  Each shard is an independent draw, from a CPU ``torch.Generator``
seeded by ``numpy.random.SeedSequence([seed, step, index])`` (the frontend
stubs' inputs by ``[seed, step, index, 1]`` for patches and ``[..., 2]``
for frames), then moved to the pipeline's device.  The values are not the
reference's: it hashes with JAX's threefry, which the port does not
reproduce.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..vector.engine import resolve_device


@dataclass
class TokenPipelineState:
    step: int = 0


def _generator(*entropy: int) -> torch.Generator:
    seed = np.random.SeedSequence(list(entropy)).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device="cpu").manual_seed(int(seed >> np.uint64(1)))


class TokenPipeline:
    """Batches of ``global_batch`` × ``seq_len`` token ids below
    ``vocab_size`` (int64, the index dtype of PyTorch's embedding and
    gather), with ``frontend`` stub inputs (``{"patches": (n, d)}`` or
    ``{"frames": (n, d)}``, float32 normal draws) where a config needs
    them, on ``device`` (CUDA unless the caller asks for the CPU)."""

    def __init__(self, vocab_size: int, global_batch: int, seq_len: int,
                 seed: int = 0, frontend: Optional[Dict] = None,
                 device=None):
        self.vocab_size = vocab_size
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.seed = seed
        self.frontend = frontend or {}
        self.device = resolve_device(device)

    def batch_at(self, step: int, shard: Tuple[int, int] = (0, 1)
                 ) -> Dict[str, torch.Tensor]:
        """Batch for ``step``; ``shard=(index, count)`` gives one of
        ``count`` equal slices of the batch axis, each drawn on its own."""
        idx, count = shard
        if self.global_batch % count:
            raise ValueError(f"a batch of {self.global_batch} does not "
                             f"split into {count} shards")
        local = self.global_batch // count
        gen = _generator(self.seed, step, idx)
        batch = {"tokens": torch.randint(0, self.vocab_size,
                                         (local, self.seq_len),
                                         generator=gen)}
        for j, name in ((1, "patches"), (2, "frames")):
            if name in self.frontend:
                n, d = self.frontend[name]
                batch[name] = torch.randn(
                    (local, n, d), generator=_generator(self.seed, step,
                                                        idx, j))
        return {k: v.to(self.device) for k, v in batch.items()}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
