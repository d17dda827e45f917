"""serve_step / prefill_step — the reference's ``models/steps.py`` for
serving: one decode step against a KV or state cache, the prompt's
prefill, and zeroed caches at a target length.  The train step, the loss and
``init_train_state`` come with the training slice (ROADMAP Queue 1 item
8(b))."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from .config import ATTN, MAMBA2, RWKV6, SHARED_ATTN, ModelConfig
from .rwkv import _dims as _rwkv_dims
from .ssm import _dims as _ssm_dims
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
