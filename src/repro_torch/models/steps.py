"""serve_step / prefill_step — the reference's ``models/steps.py`` for
serving: one decode step against a KV cache, the prompt's prefill, and
zeroed caches at a target length.  The train step, the loss and
``init_train_state`` come with the training slice (ROADMAP Queue 1 item
8(b))."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from .config import ModelConfig
from .stack import check_ported
from .stack import decode_step as _decode
from .stack import prefill


def make_serve_step(cfg: ModelConfig):
    """Returns serve_step(model, token, caches, index) -> (logits, caches)."""

    def serve_step(model, token, caches, index):
        return _decode(model, cfg, token, caches, index)

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(model, batch):
        return prefill(model, cfg, batch)

    return prefill_step


def init_decode_caches(cfg: ModelConfig, batch: int, seq_len: int,
                       dtype=None, device=None) -> Tuple[Any, Any]:
    """Zeroed attention caches (and their logical axes) for decode at
    ``seq_len``: per segment ``(layers, batch, seq_len, KV, D)`` k and v."""
    check_ported(cfg)
    dtype = dtype or cfg.activation_dtype
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    caches = {"index": 0, "segments": []}
    axes = {"index": (), "segments": []}
    for _kind, _moe, count in cfg.segments():
        shape = (count, batch, seq_len, kv, hd)
        caches["segments"].append({"mixer": {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}})
        ax = (None, "batch", "cache_seq", "kv_heads", "head_dim")
        axes["segments"].append({"mixer": {"k": ax, "v": ax}})
    return caches, axes
