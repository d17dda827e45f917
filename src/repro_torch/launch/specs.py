"""Abstract inputs for every (arch × shape) dry-run cell, the reference's
``launch/specs.py`` on the ``meta`` device: the real init functions run
with meta tensors, which have shapes and dtypes and no storage, so the
671B config costs nothing to "initialise" here (the reference traces its
init under ``jax.eval_shape``).  ``init_params`` skips its random draw on
meta: a meta generator does not exist, and the values are never read.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs import SHAPES
from ..models.config import ModelConfig
from ..optim import AdamWConfig

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor standing for an input of ``shape`` and ``dtype``."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, global_batch: int, seq_len: int
                ) -> Dict[str, torch.Tensor]:
    batch = {"tokens": sds((global_batch, seq_len), torch.int32)}
    if cfg.frontend == "vision_stub":
        batch["patches"] = sds((global_batch, cfg.frontend_seq,
                                cfg.frontend_dim), torch.float32)
    if cfg.encoder_layers:
        batch["frames"] = sds((global_batch, cfg.encoder_seq, cfg.d_model),
                              torch.float32)
    return batch


def batch_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    axes = {"tokens": ("batch", None)}
    if cfg.frontend == "vision_stub":
        axes["patches"] = ("batch", None, None)
    if cfg.encoder_layers:
        axes["frames"] = ("batch", None, None)
    return axes


def abstract_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig
                         ) -> Tuple[Any, Any]:
    """(meta train state, logical-axes tree) — no allocation."""
    from ..models import init_train_state
    return init_train_state(cfg, opt_cfg, 0, device=META)


def abstract_params(cfg: ModelConfig) -> Tuple[Any, Any]:
    from ..models import init_params
    return init_params(cfg, 0, META)


def abstract_decode_caches(cfg: ModelConfig, batch: int, seq_len: int
                           ) -> Tuple[Any, Any]:
    from ..models import init_decode_caches
    caches, axes = init_decode_caches(cfg, batch, seq_len, device=META)
    # the reference's cache index is a 0-d int32 array
    caches["index"] = sds((), torch.int32)
    return caches, axes


def input_specs(cfg: ModelConfig, shape_name: str,
                shape: Dict[str, Any] = None) -> Dict[str, Any]:
    """Everything the dry run needs to run one cell (``shape``, a dict of
    ``kind``, ``seq_len`` and ``global_batch``, replaces the named
    shape's).

    kind == train   → {"state", "state_axes", "batch", "batch_axes"}
    kind == prefill → {"params", "param_axes", "batch", "batch_axes"}
    kind == decode  → {"params", "param_axes", "token", "caches",
                       "cache_axes", "index"}
    """
    shape = shape or SHAPES[shape_name]
    B, S = shape["global_batch"], shape["seq_len"]
    if shape["kind"] == "train":
        opt_cfg = AdamWConfig(moment_dtype=cfg.opt_state_dtype)
        state, state_axes = abstract_train_state(cfg, opt_cfg)
        return {"kind": "train", "opt_cfg": opt_cfg,
                "state": state, "state_axes": state_axes,
                "batch": batch_specs(cfg, B, S),
                "batch_axes": batch_axes(cfg)}
    if shape["kind"] == "prefill":
        params, param_axes = abstract_params(cfg)
        return {"kind": "prefill",
                "params": params, "param_axes": param_axes,
                "batch": batch_specs(cfg, B, S),
                "batch_axes": batch_axes(cfg)}
    # decode: one new token against a seq_len cache
    params, param_axes = abstract_params(cfg)
    caches, cache_axes = abstract_decode_caches(cfg, B, S)
    return {"kind": "decode",
            "params": params, "param_axes": param_axes,
            "token": sds((B, 1), torch.int32),
            "caches": caches, "cache_axes": cache_axes,
            "index": sds((), torch.int32)}
