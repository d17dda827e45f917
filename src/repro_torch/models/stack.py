"""The decoder stack, the reference's ``models/stack.py`` on PyTorch, for
the dense GQA family (``qwen2p5_14b``, ``qwen3_32b``, ``starcoder2_15b``,
``deepseek_coder_33b``).

One ``nn.Module`` per level: :class:`Stack` holds the embedding, the
blocks, the final norm and the LM head; :class:`Block` one layer (norms,
:class:`~repro_torch.models.attention.Attention`, :class:`MLP`).  Each
module is a dict of its children keyed as the reference's params tree, so
the functional layers of :mod:`.layers` run on it directly.  The reference
stacks each segment's layers along a leading axis and scans them; here
they are a ``ModuleList`` run in a Python loop, and decode caches keep the
reference's stacked layout ``(layers, B, S_max, KV, D)`` per segment.

Public API (the reference's, forward only):
    init_params(cfg, seed, device=None)          -> (model, axes)
    forward_train(model, cfg, batch)             -> (logits, aux, None)
    prefill(model, cfg, batch)                   -> (logits, caches)
    decode_step(model, cfg, token, caches, i)    -> (logits, caches)

A config that needs another mixer family raises ``NotImplementedError`` at
init (:func:`unported_features`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn as nn

from ..vector.engine import resolve_device
from .attention import Attention, gqa_init
from .config import ATTN, ModelConfig, torch_dtype
from .layers import (Params, dense, dense_init, embed, embed_init, mlp,
                     mlp_init, rmsnorm, rmsnorm_init, unembed)

LATER_ITEM = "ROADMAP Queue 1 item 9 ports the other mixer families"


def unported_features(cfg: ModelConfig) -> List[str]:
    """What ``cfg`` needs that this slice of the port does not run."""
    feats = []
    kinds = set(cfg.layer_kinds())
    if kinds - {ATTN}:
        feats += sorted(kinds - {ATTN})            # mamba2, rwkv6, shared_attn
    if cfg.moe is not None:
        feats.append("moe")
    if cfg.attention != "gqa":
        feats.append(f"{cfg.attention} attention")
    if cfg.encoder_layers or cfg.cross_attention:
        feats.append("encoder and cross-attention")
    if cfg.frontend != "none":
        feats.append(cfg.frontend)
    if cfg.mtp_depth:
        feats.append("mtp")
    return feats


def check_ported(cfg: ModelConfig) -> None:
    feats = unported_features(cfg)
    if feats:
        raise NotImplementedError(
            f"{cfg.name} needs {', '.join(feats)}, which the port does not "
            f"run yet: {LATER_ITEM} (the dense GQA family runs now)")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class MLP(nn.ModuleDict):
    """The dense MLP's weights (``wi``, ``wo``, and ``wg`` for swiglu)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__({k: nn.ParameterDict(v) for k, v in params.items()})
        self.kind = cfg.mlp

    def forward(self, x):
        return mlp(self, x, self.kind)


class Block(nn.ModuleDict):
    """One ATTN layer with a dense MLP: ``ln1``, ``mixer``, ``ln2``,
    ``mlp``."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__({
            "ln1": nn.ParameterDict(params["ln1"]),
            "mixer": Attention(cfg, params["mixer"]),
            "ln2": nn.ParameterDict(params["ln2"]),
            "mlp": MLP(cfg, params["mlp"])})
        self.cfg = cfg

    def forward(self, x, causal: bool = True):
        h = rmsnorm(self["ln1"], x, self.cfg.norm_eps)
        x = x + self["mixer"](h, causal=causal)
        return self._mlp(x)

    def prefill(self, x):
        h = rmsnorm(self["ln1"], x, self.cfg.norm_eps)
        mix, c = self["mixer"].prefill(h)
        return self._mlp(x + mix), {"mixer": c}

    def decode(self, x, cache, index: int):
        h = rmsnorm(self["ln1"], x, self.cfg.norm_eps)
        mix, c = self["mixer"].decode(h, cache["mixer"], index)
        return self._mlp(x + mix), {"mixer": c}

    def _mlp(self, x):
        h = rmsnorm(self["ln2"], x, self.cfg.norm_eps)
        return x + self["mlp"](h)


def _block_init(gen, cfg: ModelConfig, dtype, device):
    p: Params = {}
    a: Params = {}
    p["ln1"], a["ln1"] = rmsnorm_init(cfg.d_model, dtype, device)
    p["mixer"], a["mixer"] = gqa_init(gen, cfg, dtype, device)
    p["ln2"], a["ln2"] = rmsnorm_init(cfg.d_model, dtype, device)
    p["mlp"], a["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dtype,
                                  device)
    return p, a


def prefix_axes(axes, prefix=None):
    """Prepend a logical axis (the stacked-layer dim) to every axes leaf."""
    if isinstance(axes, tuple):
        return (prefix,) + axes
    return {k: prefix_axes(v, prefix) for k, v in axes.items()}


class Stack(nn.Module):
    """The decoder: ``embed``, ``blocks`` (every segment's layers in
    order), ``final_norm`` and, untied, ``lm_head``.  With no generator the
    weights are left uninitialised, for a caller that loads them."""

    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        dtype = torch_dtype(cfg.param_dtype)
        p, a = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, device)
        self.embed = nn.ParameterDict(p)
        axes: Params = {"embed": a, "segments": []}
        blocks = []
        for _kind, _moe, count in cfg.segments():
            for _ in range(count):
                p, a = _block_init(gen, cfg, dtype, device)
                blocks.append(Block(cfg, p))
            axes["segments"].append(prefix_axes(a, None))
        self.blocks = nn.ModuleList(blocks)
        p, axes["final_norm"] = rmsnorm_init(cfg.d_model, dtype, device)
        self.final_norm = nn.ParameterDict(p)
        if not cfg.tie_embeddings:
            p, axes["lm_head"] = dense_init(gen, cfg.d_model,
                                            cfg.padded_vocab, None, "vocab",
                                            dtype, device=device)
            self.lm_head = nn.ParameterDict(p)
        self.axes = axes

    def segment_blocks(self) -> List[List[Block]]:
        """The blocks grouped as ``cfg.segments()`` groups the layers."""
        out, start = [], 0
        for _kind, _moe, count in self.cfg.segments():
            out.append(list(self.blocks[start:start + count]))
            start += count
        return out

    def embed_tokens(self, tokens) -> torch.Tensor:
        return embed(self.embed, tokens, self.cfg.activation_dtype)

    def logits(self, x) -> torch.Tensor:
        cfg = self.cfg
        x = rmsnorm(self.final_norm, x, cfg.norm_eps)
        if cfg.tie_embeddings:
            logits = unembed(self.embed, x)
        else:
            logits = dense(self.lm_head, x)
        if cfg.logit_softcap:
            logits = torch.tanh(logits / cfg.logit_softcap) * \
                cfg.logit_softcap
        if cfg.padded_vocab != cfg.vocab_size:
            # mask pad columns so softmax/argmax semantics are unchanged
            col = torch.arange(cfg.padded_vocab, device=logits.device)
            logits = logits.masked_fill(col >= cfg.vocab_size, -1e9)
        return logits

    @torch.inference_mode()
    def forward(self, tokens):
        """Teacher-forcing forward: tokens (B, S) → logits (B, S, V)."""
        x = self.embed_tokens(tokens)
        for blk in self.blocks:
            x = blk(x)
        return self.logits(x)

    @torch.inference_mode()
    def prefill(self, tokens):
        """Full-prefix forward building decode caches of length S."""
        x = self.embed_tokens(tokens)
        caches: Dict[str, Any] = {"index": tokens.shape[1], "segments": []}
        for seg in self.segment_blocks():
            ks, vs = [], []
            for blk in seg:
                x, c = blk.prefill(x)
                ks.append(c["mixer"]["k"])
                vs.append(c["mixer"]["v"])
            caches["segments"].append(
                {"mixer": {"k": torch.stack(ks), "v": torch.stack(vs)}})
        return self.logits(x), caches

    @torch.inference_mode()
    def decode_step(self, token, caches, index: int):
        """token (B, 1); caches written in place at ``index``."""
        x = self.embed_tokens(token)
        new = {"index": index + 1, "segments": []}
        for seg, c in zip(self.segment_blocks(), caches["segments"]):
            k, v = c["mixer"]["k"], c["mixer"]["v"]
            for i, blk in enumerate(seg):
                x, _ = blk.decode(x, {"mixer": {"k": k[i], "v": v[i]}},
                                  index)
            new["segments"].append({"mixer": {"k": k, "v": v}})
        return self.logits(x)[:, 0, :], new


# ---------------------------------------------------------------------------
# the reference's functional API
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int, device=None
                ) -> Tuple[Stack, Params]:
    """The model on ``device`` (CUDA unless the caller asks for the CPU),
    its weights drawn from ``torch.Generator(device).manual_seed(seed)``
    one tensor at a time (float32 draw, cast to ``cfg.param_dtype``), and
    its logical axes tree, the reference's."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    model = Stack(cfg, gen, dev)
    return model, model.axes


def _same_config(model: Stack, cfg: ModelConfig) -> None:
    if model.cfg != cfg:
        raise ValueError(f"the model was built for {model.cfg.name}, "
                         f"not for the config given ({cfg.name})")


def forward_train(model: Stack, cfg: ModelConfig, batch):
    """batch: {tokens (B,S)} → (logits (B,S,V), aux, None) — forward only
    (no loss, no remat); ``aux`` is the dense family's zero."""
    _same_config(model, cfg)
    logits = model(batch["tokens"])
    return logits, torch.zeros((), dtype=torch.float32,
                               device=logits.device), None


def prefill(model: Stack, cfg: ModelConfig, batch):
    """Returns (logits (B, S, V), caches)."""
    _same_config(model, cfg)
    return model.prefill(batch["tokens"])


def decode_step(model: Stack, cfg: ModelConfig, token, caches, index: int):
    """token (B, 1) int; index: current position → (logits (B, V), caches)."""
    _same_config(model, cfg)
    return model.decode_step(token, caches, int(index))
