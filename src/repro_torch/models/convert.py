"""Weights carried across packages: the reference's ``init_params`` tree
(as numpy arrays) into the port's :class:`~repro_torch.models.stack.Stack`,
and the port's per-layer tensors (weights, gradients, moments) back into
the reference's tree.

The reference stacks each segment's layers along a leading axis
(``segments[s][...]`` of shape ``(count, ...)``); the port keeps one
:class:`~repro_torch.models.stack.Block` per layer, so layer ``i`` of
segment ``s`` is block ``offset(s) + i``, counting the layers of the
segments before it that are not shared attention.  A shared-attention
segment's dict is empty in the reference (its weights are
``shared_block``, no layer axis), so it holds no block.  Whisper's
encoder stacks its blocks the same way (``encoder.blocks.<leaf>`` of
shape ``(encoder_layers, ...)``), unstacked into ``encoder.blocks.i``;
``encoder.final_norm``, InternVL's ``frontend_proj`` and DeepSeek-V3's
``mtp`` (``proj``, ``block``, ``norm``) carry over as they are.  Each leaf is
copied into the parameter's own dtype: the float32 leaves of a bfloat16
model (Mamba2's ``A_log``, ``D``, ``dt_bias``; RWKV6's ``w0``, ``u``)
stay float32.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..vector.engine import resolve_device
from .config import SHARED_ATTN, ModelConfig
from .stack import Stack


def _flatten(tree, prefix="") -> Dict[str, object]:
    """A nested tree of dicts and lists → its leaves by dotted path."""
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
    return {prefix[:-1]: tree}


def _unstack(flat: Dict[str, np.ndarray], cfg: ModelConfig
             ) -> Dict[str, np.ndarray]:
    """``segments.s.<leaf>`` of shape (count, ...) → ``blocks.j.<leaf>``;
    ``encoder.blocks.<leaf>`` of shape (encoder_layers, ...) →
    ``encoder.blocks.i.<leaf>``."""
    out, offset = {}, {}
    start = 0
    for s, (kind, _moe, count) in enumerate(cfg.segments()):
        if kind == SHARED_ATTN:
            continue
        offset[str(s)] = (start, count)
        start += count
    for name, arr in flat.items():
        parts = name.split(".")
        if parts[:2] == ["encoder", "blocks"]:
            prefix, start, count = "encoder.blocks", 0, cfg.encoder_layers
            rest = parts[2:]
        elif parts[0] == "segments":
            if len(parts) < 3 or parts[1] not in offset:
                raise KeyError(f"params_from_jax: unexpected leaf {name!r}")
            prefix, (start, count) = "blocks", offset[parts[1]]
            rest = parts[2:]
        else:
            out[name] = arr
            continue
        if not rest:
            raise KeyError(f"params_from_jax: unexpected leaf {name!r}")
        if arr.ndim == 0 or arr.shape[0] != count:
            raise ValueError(f"params_from_jax: {name} has shape "
                             f"{arr.shape}, not {count} stacked layers")
        for i in range(count):
            out[f"{prefix}.{start + i}.{'.'.join(rest)}"] = arr[i]
    return out


def params_from_jax(tree, cfg: ModelConfig, device=None) -> Stack:
    """The port's model holding exactly the weights of ``tree``, the
    reference's ``init_params(cfg, key)[0]`` with numpy leaves.  Raises on
    any leaf that is missing, left over or of the wrong shape."""
    dev = resolve_device(device)
    model = Stack(cfg, None, dev)
    want = dict(model.named_parameters())
    got = _unstack({k: np.asarray(v) for k, v in _flatten(tree).items()},
                   cfg)
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


# ---------------------------------------------------------------------------
# the other way: the port's per-layer tensors into the reference's tree
# ---------------------------------------------------------------------------


def leaf_map(cfg: ModelConfig, names) -> Dict[str, Tuple[str, int]]:
    """Each port parameter name → (the reference leaf it belongs to, its
    layer along that leaf's stacked axis, or -1 for a leaf that is not
    stacked).  ``blocks.j.<leaf>`` is layer ``j - offset(s)`` of
    ``segments.s.<leaf>``; ``encoder.blocks.i.<leaf>`` layer ``i`` of
    ``encoder.blocks.<leaf>``; every other name (the embedding, norms
    outside the segments, ``lm_head``, ``shared_block``, ``mtp``,
    ``frontend_proj``) is its own reference leaf."""
    seg_of = []
    for s, (kind, _moe, count) in enumerate(cfg.segments()):
        if kind != SHARED_ATTN:
            seg_of += [(s, i) for i in range(count)]
    out = {}
    for name in names:
        parts = name.split(".")
        if parts[:2] == ["encoder", "blocks"]:
            out[name] = ("encoder.blocks." + ".".join(parts[3:]),
                         int(parts[2]))
        elif parts[0] == "blocks":
            s, i = seg_of[int(parts[1])]
            out[name] = (f"segments.{s}." + ".".join(parts[2:]), i)
        else:
            out[name] = (name, -1)
    return out


def reference_ndim(cfg: ModelConfig, tensors: Dict[str, torch.Tensor]
                   ) -> Dict[str, int]:
    """The rank of each tensor's reference leaf: one more than its own
    where the reference stacks it along a layer axis."""
    where = leaf_map(cfg, tensors)
    return {n: t.dim() + (where[n][1] >= 0) for n, t in tensors.items()}


def to_reference_tree(cfg: ModelConfig, tensors: Dict[str, torch.Tensor]
                      ) -> dict:
    """A dict of the port's per-parameter tensors (the parameters, or
    their gradients, moments or error feedback) → the reference's nested
    tree of tensors, every stacked leaf stacked on a new leading axis in
    layer order; a shared-attention segment's entry is an empty dict, as
    in the reference."""
    where = leaf_map(cfg, tensors)
    stacks: Dict[str, list] = {}
    flat: Dict[str, torch.Tensor] = {}
    for name, t in tensors.items():
        ref, layer = where[name]
        if layer < 0:
            flat[ref] = t
        else:
            stacks.setdefault(ref, []).append((layer, t))
    for ref, items in stacks.items():
        flat[ref] = torch.stack([t for _, t in sorted(items,
                                                      key=lambda it: it[0])])
    tree: dict = {}
    for ref, t in flat.items():
        node = tree
        parts = ref.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t
    segs = tree.get("segments", {})
    tree["segments"] = [segs.get(str(s), {})
                        for s in range(len(cfg.segments()))]
    return tree


def from_reference_tree(cfg: ModelConfig, tree, names) -> Dict[str, object]:
    """The inverse of :func:`to_reference_tree`: the reference's tree (of
    arrays or tensors) → each of ``names``' leaf, one layer of a stacked
    leaf indexed off its leading axis."""
    flat = _flatten(tree)
    out = {}
    for name, (ref, layer) in leaf_map(cfg, names).items():
        if ref not in flat:
            raise KeyError(f"the reference tree has no leaf {ref!r}")
        out[name] = flat[ref] if layer < 0 else flat[ref][layer]
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()               # exact: every bf16 value is an f32
    return t.cpu().numpy()


def params_to_jax(model: Stack, cfg: ModelConfig) -> dict:
    """The inverse of :func:`params_from_jax`: the model's weights as the
    reference's ``init_params`` tree of numpy arrays, each segment's
    layers stacked (bfloat16 widened to float32, exactly)."""
    named = {n: p for n, p in model.named_parameters()}
    return tree_to_numpy(to_reference_tree(cfg, named))


def tree_to_numpy(tree):
    """A nested tree of tensors → the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to_numpy(v) for v in tree]
    return _numpy(tree)
