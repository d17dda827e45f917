"""The composable decoder (and encoder-decoder) stack, the reference's
``models/stack.py`` on PyTorch, for all ten archs of the registry: the
dense GQA family (``qwen2p5_14b``, ``qwen3_32b``, ``starcoder2_15b``,
``deepseek_coder_33b``), MoE (``granite_moe_1b``), Mamba2 with Zamba2's
shared attention block (``zamba2_2p7b``), RWKV6 (``rwkv6_1p6b``), the
encoder-decoder (``whisper_base``), the vision-stub prefix
(``internvl2_1b``) and MLA with MTP (``deepseek_v3_671b``).

One ``nn.Module`` per level: :class:`Stack` holds the embedding, the
blocks, the shared block, the final norm, the LM head, and where the
config asks for them Whisper's :class:`Encoder`, InternVL's
``frontend_proj`` and DeepSeek-V3's ``mtp`` (``proj``, ``block``,
``norm``); :class:`Block` one layer (norms, a mixer —
:class:`~.attention.Attention`, :class:`~.attention.MLA`,
:class:`~.ssm.Mamba2` or :class:`~.rwkv.RWKV6` — Whisper's ``ln_cross``
and ``cross``, and the MLP slot: a dense :class:`MLP`, a
:class:`~.moe.MoE`, RWKV's channel mix, or nothing for Mamba2).  Each
module is a :class:`~.layers.ParamTree` keyed as the reference's params
tree, so the functional layers run on it directly.  The reference stacks
each segment's layers along a leading axis and scans them; here they are
a ``ModuleList`` run in a Python loop, and decode caches keep the
reference's tree: every leaf of a segment stacked along a leading layer
axis (``k``/``v`` ``(layers, B, S_max, KV, D)``, MLA's ``c_kv``/``k_rope``,
Whisper's ``cross_kv``, Mamba2's ``conv``/``state``, RWKV6's
``x_prev``/``state``/``cmix_x_prev``), a shared-attention invocation's
``k``/``v`` unstacked ``(B, S_max, KV, D)``.

Public API (the reference's):
    init_params(cfg, seed, device=None)          -> (model, axes)
    forward_train(model, cfg, batch)             -> (logits, aux, mtp_logits)

``forward_train`` carries gradients (the train step's forward) and, with
``cfg.remat``, recomputes each block in the backward pass; ``prefill``
and ``decode_step`` run under ``torch.inference_mode``.
    prefill(model, cfg, batch)                   -> (logits, caches)
    decode_step(model, cfg, token, caches, i)    -> (logits, caches)

``batch`` is the reference's: ``tokens`` (B, S), with ``frames`` (B,
encoder_seq, d_model) for Whisper or ``patches`` (B, frontend_seq,
frontend_dim) for InternVL.
"""
from __future__ import annotations

from contextlib import ExitStack
from typing import Any, Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..sharding import is_dtensor
from ..sharding import with_logical_constraint as wlc
from ..sharding.specs import store_layer
from ..vector.engine import resolve_device
from . import rwkv as rwkv_mod
from .attention import (MLA, Attention, cross_kv, gqa_cross, gqa_init,
                        mla_init)
from .config import ATTN, MAMBA2, RWKV6, SHARED_ATTN, ModelConfig, torch_dtype
from .layers import (ParamTree, Params, dense, dense_init, embed, embed_init,
                     mlp, mlp_init, rmsnorm, rmsnorm_init, unembed)
from .moe import MoE, moe_init
from .rwkv import RWKV6 as RWKV6Mixer
from .rwkv import rwkv6_init
from .ssm import Mamba2, mamba2_init


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


def mixer_class(cfg: ModelConfig, kind: str):
    """The mixer module of a block of ``kind``: MLA for attention when the
    config asks for it, else by kind."""
    if cfg.attention == "mla" and kind in (ATTN, SHARED_ATTN):
        return MLA
    return MIXERS[kind]


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
    """One layer of kind ``kind``: ``ln1``, ``mixer``, Whisper's
    ``ln_cross`` and ``cross`` (a decoder block of a cross-attention
    config), and the MLP slot — ``ln2`` with ``mlp`` or ``moe`` for
    attention, ``ln2`` with the channel mix (``cmix_*``, ``mu_ck``,
    ``mu_cr``) for RWKV6, nothing for Mamba2."""

    def __init__(self, cfg: ModelConfig, kind: str, params: dict):
        children = {"mixer": mixer_class(cfg, kind)(cfg, params["mixer"])}
        if "cross" in params:
            children["cross"] = Attention(cfg, params["cross"])
        if "mlp" in params:
            children["mlp"] = MLP(cfg, params["mlp"])
        if "moe" in params:
            children["moe"] = MoE(cfg, params["moe"])
        super().__init__(params, children)
        self.cfg = cfg
        self.kind = kind

    def forward(self, x, enc_out=None, causal: bool = True):
        """Returns (x, aux); ``causal=False`` is the encoder's
        bidirectional attention."""
        h = rmsnorm(self["ln1"], x, self.cfg.norm_eps)
        mix = self["mixer"](h) if causal else self["mixer"](h, causal=False)
        x = x + mix
        if "cross" in self and enc_out is not None:
            x = self._cross(x, cross_kv(self["cross"], self.cfg, enc_out))
        x, aux, _ = self._ffn(x, None)
        return wlc(x, ("batch", "seq", "d_model")), aux

    def prefill(self, x, enc_out=None):
        """Returns (x, aux, cache); a cross block's cache holds the
        encoder's ``cross_kv``."""
        h = rmsnorm(self["ln1"], x, self.cfg.norm_eps)
        mix, c = self["mixer"].prefill(h)
        cache = {"mixer": c}
        x = x + mix
        if "cross" in self and enc_out is not None:
            cache["cross_kv"] = cross_kv(self["cross"], self.cfg, enc_out)
            x = self._cross(x, cache["cross_kv"])
        x, aux, h = self._ffn(x, None)
        if self.kind == RWKV6:
            cache["cmix_x_prev"] = h[:, -1:, :]
        # the residual stream's split, as the training block ends with it
        # (DTensors only: every layer then starts from the same placement)
        return wlc(x, ("batch", "seq", "d_model")), aux, cache

    def decode(self, x, cache, index: int):
        """x: (B, 1, d).  Returns (x, cache); ``cross_kv`` is read, never
        written."""
        h = rmsnorm(self["ln1"], x, self.cfg.norm_eps)
        mix, c = self["mixer"].decode(h, cache["mixer"], index)
        new = {"mixer": c}
        x = x + mix
        if "cross" in self and "cross_kv" in cache:
            x = self._cross(x, cache["cross_kv"])
            new["cross_kv"] = cache["cross_kv"]
        x, _, h = self._ffn(x, cache.get("cmix_x_prev"))
        if self.kind == RWKV6:
            new["cmix_x_prev"] = h
        return wlc(x, ("batch", "seq", "d_model")), new

    def _cross(self, x, enc_kv):
        h = rmsnorm(self["ln_cross"], x, self.cfg.norm_eps)
        return x + gqa_cross(self["cross"], self.cfg, h, enc_kv)

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
                device, cross: bool = False):
    d = cfg.d_model
    p: Params = {}
    a: Params = {}
    p["ln1"], a["ln1"] = rmsnorm_init(d, dtype, device)
    if kind in (ATTN, SHARED_ATTN):
        init = mla_init if cfg.attention == "mla" else gqa_init
        p["mixer"], a["mixer"] = init(gen, cfg, dtype, device)
    elif kind == MAMBA2:
        p["mixer"], a["mixer"] = mamba2_init(gen, cfg, dtype, device)
    elif kind == RWKV6:
        p["mixer"], a["mixer"] = rwkv6_init(gen, cfg, dtype, device)
    else:
        raise ValueError(kind)
    if cross:
        p["ln_cross"], a["ln_cross"] = rmsnorm_init(d, dtype, device)
        p["cross"], a["cross"] = gqa_init(gen, cfg, dtype, device)
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
    store_layer(tree, i, new)
    return tree


def run_block(cfg: ModelConfig, blk: Block, x, enc_out=None,
              causal: bool = True):
    """One block's training forward → (x, aux), under activation
    checkpointing when ``cfg.remat`` asks for it and gradients are on."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(blk, x, enc_out, causal, use_reentrant=False)
    return blk(x, enc_out, causal)


class Encoder(nn.Module):
    """Whisper's encoder: ``blocks`` (attention blocks without cross,
    run bidirectionally) and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, gen, dtype, device):
        super().__init__()
        self.cfg = cfg
        blocks = []
        for _ in range(cfg.encoder_layers):
            p, a = _block_init(gen, cfg, ATTN, False, dtype, device)
            blocks.append(Block(cfg, ATTN, p))
        self.blocks = nn.ModuleList(blocks)
        p, norm_axes = rmsnorm_init(cfg.d_model, dtype, device)
        self.final_norm = nn.ParameterDict(p)
        self.axes = {"blocks": prefix_axes(a, None),
                     "final_norm": norm_axes}

    def forward(self, frames):
        """frames (B, S_enc, d_model), cast to the activation dtype and
        not projected → the encoder's output."""
        x = frames.to(self.cfg.activation_dtype)
        for blk in self.blocks:
            x, _ = run_block(self.cfg, blk, x, None, causal=False)
        return rmsnorm(self.final_norm, x, self.cfg.norm_eps)


class Stack(nn.Module):
    """The decoder: ``embed``, ``blocks`` (every non-shared segment's
    layers in order), ``shared_block`` (Zamba2's one shared attention
    block, invoked at each of its segments), ``final_norm``, untied
    ``lm_head``, and by config ``encoder`` (Whisper), ``frontend_proj``
    (InternVL's patches into the LM) and ``mtp`` (DeepSeek-V3's depth-1
    multi-token prediction: ``proj``, ``block``, ``norm``).  With no
    generator the weights are left uninitialised, for a caller that loads
    them."""

    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
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
                p, a = _block_init(gen, cfg, kind, is_moe, dtype, device,
                                   cross=cfg.cross_attention)
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
        if cfg.encoder_layers:
            self.encoder = Encoder(cfg, gen, dtype, device)
            axes["encoder"] = self.encoder.axes
        if cfg.frontend == "vision_stub":
            p, axes["frontend_proj"] = dense_init(
                gen, cfg.frontend_dim, cfg.d_model, None, None, dtype,
                device=device)
            self.frontend_proj = nn.ParameterDict(p)
        if cfg.mtp_depth:
            p, a = {}, {}
            p["proj"], a["proj"] = dense_init(gen, 2 * cfg.d_model,
                                              cfg.d_model, None, None, dtype,
                                              device=device)
            p["block"], a["block"] = _block_init(gen, cfg, ATTN, False,
                                                 dtype, device)
            p["norm"], a["norm"] = rmsnorm_init(cfg.d_model, dtype, device)
            self.mtp = ParamTree(p, {"block": Block(cfg, ATTN, p["block"])})
            axes["mtp"] = a
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

    def embed_inputs(self, batch) -> torch.Tensor:
        """The token embeddings, after InternVL's projected patches (cast
        to the activation dtype before the projection)."""
        x = self.embed_tokens(batch["tokens"])
        if self.cfg.frontend == "vision_stub":
            patches = batch["patches"].to(self.cfg.activation_dtype)
            x = torch.cat([dense(self.frontend_proj, patches), x], dim=1)
        return wlc(x, ("batch", "seq", "d_model"))

    def encode(self, batch):
        """Whisper's encoder output over ``batch["frames"]``; None without
        an encoder."""
        if not self.cfg.encoder_layers:
            return None
        return self.encoder(batch["frames"])

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
        return wlc(logits, ("batch", "seq", "vocab"))

    def forward(self, batch):
        """Teacher-forcing forward over the batch dict → (logits (B, S*,
        V), the summed MoE aux, the MTP logits or None).  Gradients flow
        unless the caller turns them off; with ``cfg.remat`` each block
        (the encoder's too) keeps only its input for the backward pass and
        recomputes the rest, as the reference's ``jax.checkpoint`` does."""
        x = self.embed_inputs(batch)
        enc_out = self.encode(batch)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for shared, seg in self.segment_blocks():
            seg_aux = torch.zeros_like(aux)
            for blk in seg:
                # a stacked segment's blocks are rematerialised, the
                # shared block is not (the reference's _scan_segment)
                x, a = (blk(x, enc_out) if shared else
                        run_block(self.cfg, blk, x, enc_out))
                seg_aux = seg_aux + a
            aux = aux + seg_aux
        logits = self.logits(x)
        if not self.cfg.mtp_depth:
            return logits, aux, None
        # multi-token prediction (depth 1): the hidden state before the
        # final norm with the next token's embedding (wrapping around at
        # the end), one more block, its norm, then the final norm again
        emb = self.embed_tokens(batch["tokens"])
        # torch.roll(emb, -1, dims=1) as slices: DTensor on torch 2.11
        # has no rule for roll
        emb_next = torch.cat([emb[:, 1:], emb[:, :1]], dim=1)
        pad = x.shape[1] - emb_next.shape[1]
        if pad:
            emb_next = F.pad(emb_next, [0, 0, pad, 0])
        h = dense(self.mtp["proj"], torch.cat([x, emb_next], dim=-1))
        h, _ = self.mtp["block"](h)
        h = rmsnorm(self.mtp["norm"], h, self.cfg.norm_eps)
        return logits, aux, self.logits(h)

    def _no_grad(self):
        """inference_mode, or for DTensor weights no_grad (DTensor's views
        need version counters, which inference tensors lack) with the
        plain tensors made inside counted as replicated."""
        if is_dtensor(self.final_norm["scale"]):
            from torch.distributed.tensor.experimental import \
                implicit_replication
            stack = ExitStack()
            stack.enter_context(torch.no_grad())
            stack.enter_context(implicit_replication())
            return stack
        return torch.inference_mode()

    def prefill(self, batch):
        """Full-prefix forward building decode caches of the prefix's
        length (InternVL's patches included)."""
        with self._no_grad():
            return self._prefill(batch)

    def _prefill(self, batch):
        x = self.embed_inputs(batch)
        enc_out = self.encode(batch)
        caches: Dict[str, Any] = {"index": x.shape[1], "segments": []}
        for shared, seg in self.segment_blocks():
            cs = []
            for blk in seg:
                x, _, c = blk.prefill(x, enc_out)
                cs.append(c)
            caches["segments"].append(cs[0] if shared else _stack_trees(cs))
        return self.logits(x), caches

    def decode_step(self, token, caches, index: int):
        """token (B, 1); caches written in place at ``index``."""
        with self._no_grad():
            return self._decode_step(token, caches, index)

    def _decode_step(self, token, caches, index: int):
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
    its logical axes tree, the reference's.  On the ``meta`` device the
    draw is skipped: the model has the shapes and dtypes and no storage
    (the reference's ``jax.eval_shape`` of its init)."""
    if device is not None and torch.device(device).type == "meta":
        model = Stack(cfg, None, torch.device("meta"))
        return model, model.axes
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    model = Stack(cfg, gen, dev)
    return model, model.axes


def _same_config(model: Stack, cfg: ModelConfig) -> None:
    if model.cfg != cfg:
        raise ValueError(f"the model was built for {model.cfg.name}, "
                         f"not for the config given ({cfg.name})")


def forward_train(model: Stack, cfg: ModelConfig, batch):
    """batch: {tokens (B,S), [patches|frames]} → (logits (B,S*,V), aux,
    mtp_logits), with gradients unless the caller turns them off; ``aux``
    is the MoE layers' summed load-balancing loss, zero without MoE;
    ``mtp_logits`` None without MTP."""
    _same_config(model, cfg)
    return model(batch)


def prefill(model: Stack, cfg: ModelConfig, batch):
    """Returns (logits (B, S*, V), caches)."""
    _same_config(model, cfg)
    return model.prefill(batch)


def decode_step(model: Stack, cfg: ModelConfig, token, caches, index: int):
    """token (B, 1) int; index: current position → (logits (B, V), caches)."""
    _same_config(model, cfg)
    return model.decode_step(token, caches, int(index))
