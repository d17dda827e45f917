"""train_step / serve_step — the reference's ``models/steps.py`` on
PyTorch: the loss and one AdamW step (forward, backward, optional int8
gradient compression with error feedback, clip, update), one decode step
against a KV or state cache, the prompt's prefill, and zeroed caches at a
target length.

The train state is ``{"params": Stack, "opt": {"mu", "nu", "step"},
"err"?}``: ``mu``, ``nu`` and ``err`` hold one tensor per parameter, keyed
by the parameter's name, and the update writes the model's parameters and
the moments in place.  :func:`state_tree` gives the state in the
reference's tree (each segment's layers stacked), which is what a
checkpoint holds, and :func:`load_state_tree` reads such a tree back.

State placed as DTensors over a ``DeviceMesh`` (``sharding.specs``, the
launchers' production mesh) runs the same steps: DTensor's sharding
propagation runs each op on the local blocks, plain tensors made inside
the step (positions, masks) count as replicated, the update runs on each
rank's blocks, the metrics are the global values, and :func:`state_tree`
holds full tensors, as the reference's checkpoint holds global arrays.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..optim import (AdamWConfig, adamw_init, adamw_update,
                     compress_gradients, decompress_gradients)
from ..sharding import full, is_dtensor, replicate
from .config import ATTN, MAMBA2, RWKV6, SHARED_ATTN, ModelConfig
from .convert import (from_reference_tree, leaf_map, reference_ndim,
                      to_reference_tree)
from .rwkv import _dims as _rwkv_dims
from .ssm import _dims as _ssm_dims
from .stack import decode_step as _decode
from .stack import forward_train, init_params, prefill

MTP_WEIGHT = 0.1


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean negative log-likelihood of ``targets`` under ``logits`` (in
    float32), over the positions ``mask`` keeps."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, targets[..., None].long())[..., 0]
    if mask is not None:
        return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return -torch.mean(ll)


def loss_fn(model, cfg: ModelConfig, batch) -> Tuple[torch.Tensor, Dict]:
    """(loss, metrics): next-token cross entropy over the token region
    (a frontend's prefix cut off), plus the MoE aux loss, plus
    ``MTP_WEIGHT`` × the MTP loss (predicting token t+2 from position
    t)."""
    logits, aux, mtp_logits = forward_train(model, cfg, batch)
    tokens = batch["tokens"]
    S_tok = tokens.shape[1]
    logits_tok = logits[:, -S_tok:, :]
    loss = cross_entropy(logits_tok[:, :-1], tokens[:, 1:])
    metrics = {"ce": loss, "aux": aux}
    loss = loss + aux
    if mtp_logits is not None:
        mtp_tok = mtp_logits[:, -S_tok:, :]
        mtp_loss = cross_entropy(mtp_tok[:, :-2], tokens[:, 2:])
        metrics["mtp"] = mtp_loss
        loss = loss + MTP_WEIGHT * mtp_loss
    metrics["loss"] = loss
    return loss, metrics


def _mesh_context(tensor):
    """Plain tensors made inside a step count as replicated when the
    step's state is a DTensor (``implicit_replication``)."""
    if is_dtensor(tensor):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        return implicit_replication()
    return nullcontext()


def _pods():
    """The model mesh when it has a ``pod`` axis of more than one rank
    (state replicated over pods, ``sharding.specs.state_mesh``), else
    None."""
    from ..launch.mesh import current_model_mesh
    mesh = current_model_mesh()
    if mesh is None or mesh.shape.get("pod", 1) == 1:
        return None
    return mesh


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    compress: bool = False):
    """Returns train_step(state, batch) -> (state, metrics), metrics the
    reference's (``ce``, ``aux``, ``mtp`` with MTP, ``loss``,
    ``grad_norm``, ``lr``) as 0-d tensors.  With ``compress`` the
    gradients go through int8 with error feedback (one scale per reference
    leaf) before the update.  Decay follows each parameter's reference
    rank."""
    cache: Dict[str, Any] = {}

    def train_step(state, batch):
        model = state["params"]
        params = dict(model.named_parameters())
        if not cache:
            cache["ndim"] = reference_ndim(cfg, params)
            cache["groups"] = {n: ref for n, (ref, _) in
                               leaf_map(cfg, params).items()}
        for p in params.values():
            p.grad = None
        first = next(iter(params.values()))
        with _mesh_context(first):
            loss, metrics = loss_fn(model, cfg, batch)
            # a DTensor loss (a partial mean over ranks) made whole, so
            # that the backward pass starts from the global loss
            replicate(loss).backward()
        # a parameter the loss does not reach has a zero gradient
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        pods = _pods()
        if is_dtensor(first):
            # each gradient on its parameter's blocks
            grads = {n: g if list(g.placements) == list(params[n].placements)
                     else g.redistribute(params[n].device_mesh,
                                         params[n].placements)
                     for n, g in grads.items()}
            if pods is not None:
                # each pod ran its block of the batch on a whole replica
                # of the state: the mean over pods is the batch's gradient
                with torch.no_grad():
                    for g in grads.values():
                        local = g.to_local()
                        local.copy_(pods.pmean(local, ["pod"]))
        new = dict(state)
        if compress:
            compressed, err = compress_gradients(grads, state.get("err"),
                                                 cache["groups"])
            grads = decompress_gradients(compressed)
            new["err"] = err
        _, new["opt"], opt_metrics = adamw_update(
            params, grads, state["opt"], opt_cfg, cache["ndim"])
        for p in params.values():
            p.grad = None
        del grads
        out = {k: full(v.detach()) for k, v in metrics.items()}
        if pods is not None:
            out = {k: pods.pmean(v, ["pod"]) for k, v in out.items()}
        out.update(opt_metrics)
        return new, out

    return train_step


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig, seed: int,
                     compress: bool = False, device=None
                     ) -> Tuple[Dict, Dict]:
    """Returns (state, axes): the model from ``seed`` on ``device`` (CUDA
    unless the caller asks for the CPU), zero moments, a zero error tree
    with ``compress``; ``axes`` the reference's logical axes of the
    state."""
    model, axes = init_params(cfg, seed, device)
    params = dict(model.named_parameters())
    state = {"params": model, "opt": adamw_init(params, opt_cfg)}
    state_axes = {"params": axes,
                  "opt": {"mu": axes, "nu": axes, "step": ()}}
    if compress:
        state["err"] = {n: torch.zeros_like(p, dtype=torch.float32)
                        for n, p in params.items()}
        state_axes["err"] = axes
    return state, state_axes


def state_tree(state: Dict, cfg: ModelConfig, leaf=None) -> Dict:
    """The train state in the reference's tree, tensors stacked per
    segment (copies; ``step`` as it is).  ``leaf(t)`` gives each tensor's
    value in the tree, one tensor after another; by default its whole
    value where it lies (a DTensor gathered: a collective)."""
    leaf = leaf or (lambda t: full(t.detach()))

    def whole(d):
        return {n: leaf(t) for n, t in d.items()}

    named = whole(dict(state["params"].named_parameters()))
    tree = {"params": to_reference_tree(cfg, named),
            "opt": {"mu": to_reference_tree(cfg, whole(state["opt"]["mu"])),
                    "nu": to_reference_tree(cfg, whole(state["opt"]["nu"])),
                    "step": leaf(state["opt"]["step"])}}
    if "err" in state:
        tree["err"] = to_reference_tree(cfg, whole(state["err"]))
    return tree


def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(v))


@torch.no_grad()
def load_state_tree(state: Dict, tree: Dict, cfg: ModelConfig) -> Dict:
    """Copy a state in the reference's tree (arrays or tensors, as a
    checkpoint restores it) into ``state``'s tensors, in place; returns
    ``state`` with its step replaced."""
    params = dict(state["params"].named_parameters())
    parts = [(params, tree["params"]), (state["opt"]["mu"],
                                        tree["opt"]["mu"]),
             (state["opt"]["nu"], tree["opt"]["nu"])]
    if "err" in state:
        parts.append((state["err"], tree["err"]))
    for dst, src in parts:
        for name, v in from_reference_tree(cfg, src, dst).items():
            t = dst[name]
            if is_dtensor(t):
                from ..sharding.specs import local_block
                t.to_local().copy_(local_block(_as_tensor(v),
                                               t.device_mesh, t.placements))
            else:
                t.copy_(_as_tensor(v))
    step = state["opt"]["step"]
    state["opt"]["step"] = _as_tensor(tree["opt"]["step"]).to(
        device=step.device, dtype=step.dtype).reshape(())
    return state


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
    """Zeroed caches (and their logical axes) for decode at ``seq_len``,
    the reference's tree, shapes, dtypes and axes: per segment stacked on
    a leading layer axis — attention ``k``/``v`` ``(layers, batch,
    seq_len, KV, D)``, or MLA's ``c_kv`` ``(layers, batch, seq_len,
    kv_lora_rank)`` and ``k_rope`` ``(layers, batch, seq_len,
    rope_head_dim)``, and with cross-attention ``cross_kv``'s ``k``/``v``
    ``(layers, batch, encoder_seq, KV, D)``; Mamba2 ``conv`` ``(layers,
    batch, K-1, d_in+2N)`` and a float32 ``state`` ``(layers, batch, H, P,
    N)``; RWKV6 ``x_prev`` and ``cmix_x_prev`` ``(layers, batch, 1, d)``
    and a float32 ``state`` ``(layers, batch, H, N, N)`` — and a
    shared-attention invocation's leaves without the layer axis.  The
    reference's ``cross_kv["v"]`` is its ``["k"]`` array itself; here each
    is a tensor of its own, since decode could write one in place."""
    dtype = dtype or cfg.activation_dtype
    caches = {"index": 0, "segments": []}
    axes = {"index": (), "segments": []}

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    for kind, _moe, count in cfg.segments():
        lead = () if kind == SHARED_ATTN else (count,)
        lax = () if kind == SHARED_ATTN else (None,)
        if kind in (ATTN, SHARED_ATTN):
            kv, hd = cfg.num_kv_heads, cfg.head_dim
            if cfg.attention == "mla":
                ax = lax + ("batch", "cache_seq", None)
                c = {"mixer": {
                    "c_kv": zeros(lead + (batch, seq_len, cfg.kv_lora_rank)),
                    "k_rope": zeros(lead + (batch, seq_len,
                                            cfg.rope_head_dim))}}
                a = {"mixer": {"c_kv": ax, "k_rope": ax}}
            else:
                ax = lax + ("batch", "cache_seq", "kv_heads", "head_dim")
                c = {"mixer": {"k": zeros(lead + (batch, seq_len, kv, hd)),
                               "v": zeros(lead + (batch, seq_len, kv, hd))}}
                a = {"mixer": {"k": ax, "v": ax}}
            if cfg.cross_attention:
                shape = lead + (batch, cfg.encoder_seq, kv, hd)
                ax = lax + ("batch", None, "kv_heads", "head_dim")
                c["cross_kv"] = {"k": zeros(shape), "v": zeros(shape)}
                a["cross_kv"] = {"k": ax, "v": ax}
        elif kind == MAMBA2:
            d_in, H, P, N = _ssm_dims(cfg)
            K = cfg.ssm.conv_width
            c = {"mixer": {
                "conv": zeros(lead + (batch, K - 1, d_in + 2 * N)),
                "state": zeros(lead + (batch, H, P, N), torch.float32)}}
            a = {"mixer": {"conv": lax + ("batch", None, "heads"),
                           "state": lax + ("batch", "heads", None,
                                           "states")}}
        elif kind == RWKV6:
            H, N = _rwkv_dims(cfg)
            c = {"mixer": {
                "x_prev": zeros(lead + (batch, 1, cfg.d_model)),
                "state": zeros(lead + (batch, H, N, N), torch.float32)},
                "cmix_x_prev": zeros(lead + (batch, 1, cfg.d_model))}
            a = {"mixer": {"x_prev": lax + ("batch", None, None),
                           "state": lax + ("batch", "heads", None,
                                           "states")},
                 "cmix_x_prev": lax + ("batch", None, None)}
        else:
            raise ValueError(kind)
        caches["segments"].append(c)
        axes["segments"].append(a)
    return caches, axes
