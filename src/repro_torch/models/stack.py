"""The decoder stack, the reference's ``models/stack.py`` on PyTorch, for
the dense GQA family (``qwen2p5_14b``, ``qwen3_32b``, ``starcoder2_15b``,
``deepseek_coder_33b``), MoE (``granite_moe_1b``), Mamba2 with Zamba2's
shared attention block (``zamba2_2p7b``) and RWKV6 (``rwkv6_1p6b``).

One ``nn.Module`` per level: :class:`Stack` holds the embedding, the
blocks, the shared block, the final norm and the LM head; :class:`Block`
one layer (norms, a mixer — :class:`~.attention.Attention`,
:class:`~.ssm.Mamba2` or :class:`~.rwkv.RWKV6` — and the MLP slot: a
dense :class:`MLP`, a :class:`~.moe.MoE`, RWKV's channel mix, or nothing
for Mamba2).  Each module is a :class:`~.layers.ParamTree` keyed as the
reference's params tree, so the functional layers run on it directly.
The reference stacks each segment's layers along a leading axis and scans
them; here they are a ``ModuleList`` run in a Python loop, and decode
caches keep the reference's tree: every leaf of a segment stacked along a
leading layer axis (``k``/``v`` ``(layers, B, S_max, KV, D)``, Mamba2's
``conv``/``state``, RWKV6's ``x_prev``/``state``/``cmix_x_prev``), a
shared-attention invocation's ``k``/``v`` unstacked ``(B, S_max, KV, D)``.

Public API (the reference's, forward only):
    init_params(cfg, seed, device=None)          -> (model, axes)
    forward_train(model, cfg, batch)             -> (logits, aux, None)
    prefill(model, cfg, batch)                   -> (logits, caches)
    decode_step(model, cfg, token, caches, i)    -> (logits, caches)

A config that needs a feature not ported yet raises
``NotImplementedError`` at init (:func:`unported_features`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..vector.engine import resolve_device
from . import rwkv as rwkv_mod
from .attention import Attention, gqa_init
from .config import ATTN, MAMBA2, RWKV6, SHARED_ATTN, ModelConfig, torch_dtype
from .layers import (ParamTree, Params, dense, dense_init, embed, embed_init,
                     mlp, mlp_init, rmsnorm, rmsnorm_init, unembed)
from .moe import MoE, moe_init
from .rwkv import RWKV6 as RWKV6Mixer
from .rwkv import rwkv6_init
from .ssm import Mamba2, mamba2_init

LATER_ITEM = ("ROADMAP Queue 1 item 9 ports them next: Whisper's encoder "
              "and cross-attention and InternVL's vision stub, then "
              "DeepSeek-V3's MLA and MTP")


def unported_features(cfg: ModelConfig) -> List[str]:
    """What ``cfg`` needs that the port does not run yet."""
    feats = []
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
            f"run yet: {LATER_ITEM} (the dense GQA, MoE, Mamba2 and RWKV6 "
            f"families run now)")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class MLP(ParamTree):
    """The dense MLP's weights (``wi``, ``wo``, and ``wg`` for swiglu)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__(params)
        self.kind = cfg.mlp

    def forward(self, x):
        return mlp(self, x, self.kind)


MIXERS = {ATTN: Attention, SHARED_ATTN: Attention, MAMBA2: Mamba2,
          RWKV6: RWKV6Mixer}


def channel_mix(p, cfg: ModelConfig, x, x_prev):
    """RWKV squared-relu channel mix with token shift."""
    shifted = rwkv_mod._shift(x, x_prev)
    mk = p["mu_ck"].to(x.dtype)[None, None, :]
    mr = p["mu_cr"].to(x.dtype)[None, None, :]
    xk = x * (1 - mk) + shifted * mk
    xr = x * (1 - mr) + shifted * mr
    k = torch.square(F.relu(dense(p["cmix_k"], xk)))
    return torch.sigmoid(dense(p["cmix_r"], xr)) * dense(p["cmix_v"], k)


class Block(ParamTree):
    """One layer of kind ``kind``: ``ln1``, ``mixer``, and the MLP slot —
    ``ln2`` with ``mlp`` or ``moe`` for attention, ``ln2`` with the
    channel mix (``cmix_*``, ``mu_ck``, ``mu_cr``) for RWKV6, nothing for
    Mamba2."""

    def __init__(self, cfg: ModelConfig, kind: str, params: dict):
        children = {"mixer": MIXERS[kind](cfg, params["mixer"])}
        if "mlp" in params:
            children["mlp"] = MLP(cfg, params["mlp"])
        if "moe" in params:
            children["moe"] = MoE(cfg, params["moe"])
        super().__init__(params, children)
        self.cfg = cfg
        self.kind = kind

    def forward(self, x):
        """Returns (x, aux)."""
        h = rmsnorm(self["ln1"], x, self.cfg.norm_eps)
        x, aux, _ = self._ffn(x + self["mixer"](h), None)
        return x, aux

    def prefill(self, x):
        """Returns (x, aux, cache)."""
        h = rmsnorm(self["ln1"], x, self.cfg.norm_eps)
        mix, c = self["mixer"].prefill(h)
        x, aux, h = self._ffn(x + mix, None)
        cache = {"mixer": c}
        if self.kind == RWKV6:
            cache["cmix_x_prev"] = h[:, -1:, :]
        return x, aux, cache

    def decode(self, x, cache, index: int):
        """x: (B, 1, d).  Returns (x, cache)."""
        h = rmsnorm(self["ln1"], x, self.cfg.norm_eps)
        mix, c = self["mixer"].decode(h, cache["mixer"], index)
        x, _, h = self._ffn(x + mix, cache.get("cmix_x_prev"))
        new = {"mixer": c}
        if self.kind == RWKV6:
            new["cmix_x_prev"] = h
        return x, new

    def _ffn(self, x, x_prev):
        """The MLP slot: (x, aux, its input ``h``) — ``h`` is the channel
        mix's next ``x_prev`` in an RWKV6 block; ``x_prev`` None is the
        sequence's start."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        h = None
        if "moe" in self:
            h = rmsnorm(self["ln2"], x, self.cfg.norm_eps)
            y, aux = self["moe"](h)
            x = x + y
        elif "mlp" in self:
            h = rmsnorm(self["ln2"], x, self.cfg.norm_eps)
            x = x + self["mlp"](h)
        elif self.kind == RWKV6:
            h = rmsnorm(self["ln2"], x, self.cfg.norm_eps)
            if x_prev is None:
                x_prev = x.new_zeros((x.shape[0], 1, x.shape[2]))
            x = x + channel_mix(self, self.cfg, h, x_prev)
        return x, aux, h


def _block_init(gen, cfg: ModelConfig, kind: str, is_moe: bool, dtype,
                device):
    d = cfg.d_model
    p: Params = {}
    a: Params = {}
    p["ln1"], a["ln1"] = rmsnorm_init(d, dtype, device)
    if kind in (ATTN, SHARED_ATTN):
        p["mixer"], a["mixer"] = gqa_init(gen, cfg, dtype, device)
    elif kind == MAMBA2:
        p["mixer"], a["mixer"] = mamba2_init(gen, cfg, dtype, device)
    elif kind == RWKV6:
        p["mixer"], a["mixer"] = rwkv6_init(gen, cfg, dtype, device)
    else:
        raise ValueError(kind)
    # MLP slot: attention blocks get a dense MLP or MoE; mamba blocks are
    # mixer-only; rwkv blocks use the squared-relu channel mix.
    if kind in (ATTN, SHARED_ATTN):
        p["ln2"], a["ln2"] = rmsnorm_init(d, dtype, device)
        if is_moe:
            p["moe"], a["moe"] = moe_init(gen, cfg, dtype, device)
        else:
            p["mlp"], a["mlp"] = mlp_init(gen, d, cfg.d_ff, cfg.mlp, dtype,
                                          device)
    elif kind == RWKV6:
        p["ln2"], a["ln2"] = rmsnorm_init(d, dtype, device)
        p["cmix_k"], a["cmix_k"] = dense_init(gen, d, cfg.d_ff, None, "ffn",
                                              dtype, device=device)
        p["cmix_v"], a["cmix_v"] = dense_init(gen, cfg.d_ff, d, "ffn", None,
                                              dtype, device=device)
        p["cmix_r"], a["cmix_r"] = dense_init(gen, d, d, None, None, dtype,
                                              device=device)
        p["mu_ck"] = torch.full((d,), 0.5, dtype=dtype, device=device)
        a["mu_ck"] = (None,)
        p["mu_cr"] = torch.full((d,), 0.5, dtype=dtype, device=device)
        a["mu_cr"] = (None,)
    return p, a


def prefix_axes(axes, prefix=None):
    """Prepend a logical axis (the stacked-layer dim) to every axes leaf."""
    if isinstance(axes, tuple):
        return (prefix,) + axes
    return {k: prefix_axes(v, prefix) for k, v in axes.items()}


def _stack_trees(trees):
    """Per-layer cache trees → one tree, each leaf stacked on axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _layer_view(tree, i: int):
    """Layer ``i`` of a stacked cache tree, as views."""
    if isinstance(tree, dict):
        return {k: _layer_view(v, i) for k, v in tree.items()}
    return tree[i]


def _store_layer(tree, i: int, new):
    """Write layer ``i``'s new cache into the stacked tree in place (a leaf
    that the layer already wrote in place, attention's k/v, is left);
    returns a new tree of the same tensors."""
    if isinstance(tree, dict):
        return {k: _store_layer(tree[k], i, new[k]) for k in tree}
    dst = tree[i]
    if new.data_ptr() != dst.data_ptr():
        dst.copy_(new)
    return tree


class Stack(nn.Module):
    """The decoder: ``embed``, ``blocks`` (every non-shared segment's
    layers in order), ``shared_block`` (Zamba2's one shared attention
    block, invoked at each of its segments), ``final_norm`` and, untied,
    ``lm_head``.  With no generator the weights are left uninitialised,
    for a caller that loads them."""

    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        dtype = torch_dtype(cfg.param_dtype)
        p, a = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, device)
        self.embed = nn.ParameterDict(p)
        axes: Params = {"embed": a, "segments": []}
        blocks = []
        for kind, is_moe, count in cfg.segments():
            if kind == SHARED_ATTN:
                axes["segments"].append({})   # weights in shared_block
                continue
            for _ in range(count):
                p, a = _block_init(gen, cfg, kind, is_moe, dtype, device)
                blocks.append(Block(cfg, kind, p))
            axes["segments"].append(prefix_axes(a, None))
        self.blocks = nn.ModuleList(blocks)
        if cfg.shared_attn_every:
            p, axes["shared_block"] = _block_init(gen, cfg, SHARED_ATTN,
                                                  False, dtype, device)
            self.shared_block = Block(cfg, SHARED_ATTN, p)
        p, axes["final_norm"] = rmsnorm_init(cfg.d_model, dtype, device)
        self.final_norm = nn.ParameterDict(p)
        if not cfg.tie_embeddings:
            p, axes["lm_head"] = dense_init(gen, cfg.d_model,
                                            cfg.padded_vocab, None, "vocab",
                                            dtype, device=device)
            self.lm_head = nn.ParameterDict(p)
        self.axes = axes

    def segment_blocks(self) -> List[Tuple[bool, List[Block]]]:
        """Per segment of ``cfg.segments()``: (shared, its blocks) —
        ``[shared_block]`` for a shared-attention segment."""
        out, start = [], 0
        for kind, _moe, count in self.cfg.segments():
            if kind == SHARED_ATTN:
                out.append((True, [self.shared_block]))
                continue
            out.append((False, list(self.blocks[start:start + count])))
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
        """Teacher-forcing forward: tokens (B, S) → (logits (B, S, V), the
        summed MoE aux)."""
        x = self.embed_tokens(tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for _shared, seg in self.segment_blocks():
            seg_aux = torch.zeros_like(aux)
            for blk in seg:
                x, a = blk(x)
                seg_aux = seg_aux + a
            aux = aux + seg_aux
        return self.logits(x), aux

    @torch.inference_mode()
    def prefill(self, tokens):
        """Full-prefix forward building decode caches of length S."""
        x = self.embed_tokens(tokens)
        caches: Dict[str, Any] = {"index": tokens.shape[1], "segments": []}
        for shared, seg in self.segment_blocks():
            cs = []
            for blk in seg:
                x, _, c = blk.prefill(x)
                cs.append(c)
            caches["segments"].append(cs[0] if shared else _stack_trees(cs))
        return self.logits(x), caches

    @torch.inference_mode()
    def decode_step(self, token, caches, index: int):
        """token (B, 1); caches written in place at ``index``."""
        x = self.embed_tokens(token)
        new = {"index": index + 1, "segments": []}
        for (shared, seg), c in zip(self.segment_blocks(),
                                    caches["segments"]):
            if shared:
                x, c = seg[0].decode(x, c, index)
            else:
                for i, blk in enumerate(seg):
                    x, nc = blk.decode(x, _layer_view(c, i), index)
                    c = _store_layer(c, i, nc)
            new["segments"].append(c)
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
    (no loss, no remat); ``aux`` is the MoE layers' summed load-balancing
    loss, zero without MoE."""
    _same_config(model, cfg)
    logits, aux = model(batch["tokens"])
    return logits, aux, None


def prefill(model: Stack, cfg: ModelConfig, batch):
    """Returns (logits (B, S, V), caches)."""
    _same_config(model, cfg)
    return model.prefill(batch["tokens"])


def decode_step(model: Stack, cfg: ModelConfig, token, caches, index: int):
    """token (B, 1) int; index: current position → (logits (B, V), caches)."""
    _same_config(model, cfg)
    return model.decode_step(token, caches, int(index))
