"""Weights carried across packages: the reference's ``init_params`` tree
(as numpy arrays) into the port's :class:`~repro_torch.models.stack.Stack`.

The reference stacks each segment's layers along a leading axis
(``segments[s][...]`` of shape ``(count, ...)``); the port keeps one
:class:`~repro_torch.models.stack.Block` per layer, so layer ``i`` of
segment ``s`` is block ``offset(s) + i``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..vector.engine import resolve_device
from .config import ModelConfig
from .stack import Stack


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _unstack(flat: Dict[str, np.ndarray], cfg: ModelConfig
             ) -> Dict[str, np.ndarray]:
    """``segments.s.<leaf>`` of shape (count, ...) → ``blocks.j.<leaf>``."""
    out, offset = {}, {}
    start = 0
    for s, (_kind, _moe, count) in enumerate(cfg.segments()):
        offset[str(s)] = (start, count)
        start += count
    for name, arr in flat.items():
        parts = name.split(".")
        if parts[0] != "segments":
            out[name] = arr
            continue
        if len(parts) < 3 or parts[1] not in offset:
            raise KeyError(f"params_from_jax: unexpected leaf {name!r}")
        start, count = offset[parts[1]]
        rest = ".".join(parts[2:])
        if arr.ndim == 0 or arr.shape[0] != count:
            raise ValueError(f"params_from_jax: {name} has shape "
                             f"{arr.shape}, not {count} stacked layers")
        for i in range(count):
            out[f"blocks.{start + i}.{rest}"] = arr[i]
    return out


def params_from_jax(tree, cfg: ModelConfig, device=None) -> Stack:
    """The port's model holding exactly the weights of ``tree``, the
    reference's ``init_params(cfg, key)[0]`` with numpy leaves.  Raises on
    any leaf that is missing, left over or of the wrong shape."""
    dev = resolve_device(device)
    model = Stack(cfg, None, dev)
    want = dict(model.named_parameters())
    got = _unstack(_flatten(tree), cfg)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"params_from_jax: missing {missing}, left over "
                       f"{extra}")
    with torch.no_grad():
        for name, param in want.items():
            arr = got[name]
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(f"params_from_jax: {name} has shape "
                                 f"{arr.shape}, the model {tuple(param.shape)}")
            if arr.dtype.kind != "f" or arr.dtype.itemsize not in (4, 8):
                arr = arr.astype(np.float32)       # bfloat16 and the like
            param.copy_(torch.tensor(arr))
    return model
