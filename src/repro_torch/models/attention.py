"""Attention: GQA (RoPE, qk-norm, qkv-bias), the reference's
``models/attention.py`` on PyTorch.

Three entry points:

* ``gqa_train``   — full-sequence causal (or bidirectional) attention, an
  online softmax over KV chunks (a Python loop over chunks), so the score
  matrix is never fully materialized for long sequences;
* ``gqa_prefill`` — the train-path forward that also returns the KV cache;
* ``gqa_decode``  — one query token against a KV cache, written in place.

Plain PyTorch ops only (``torch.einsum``, ``softmax``).  MLA (DeepSeek-V3)
and cross-attention (Whisper) belong to a later slice of the port
(ROADMAP Queue 1 item 9); their entry points raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch

from .config import ModelConfig
from .layers import (ParamTree, apply_rope, dense, dense_init, rmsnorm,
                     rmsnorm_init)

ATTN_CHUNK_Q = 1024  # query chunk for online-softmax attention
ATTN_CHUNK_K = 2048  # KV chunk

LATER_SLICE = ("ROADMAP Queue 1 item 9 (the other mixer families) ports "
               "MLA and cross-attention")


def set_chunk_sizes(q: int, k: int) -> None:
    """The query and KV chunk lengths of :func:`_sdpa` (the reference's
    setter of the same name)."""
    global ATTN_CHUNK_Q, ATTN_CHUNK_K
    ATTN_CHUNK_Q, ATTN_CHUNK_K = q, k


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def gqa_init(gen, cfg: ModelConfig, dtype, device=None):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p, a = {}, {}
    p["wq"], a["wq"] = dense_init(gen, d, h * hd, None, "heads", dtype,
                                  bias=cfg.qkv_bias, device=device)
    p["wk"], a["wk"] = dense_init(gen, d, kv * hd, None, "kv_heads", dtype,
                                  bias=cfg.qkv_bias, device=device)
    p["wv"], a["wv"] = dense_init(gen, d, kv * hd, None, "kv_heads", dtype,
                                  bias=cfg.qkv_bias, device=device)
    p["wo"], a["wo"] = dense_init(gen, h * hd, d, "heads", None, dtype,
                                  device=device)
    if cfg.qk_norm:
        p["qnorm"], a["qnorm"] = rmsnorm_init(hd, dtype, device)
        p["knorm"], a["knorm"] = rmsnorm_init(hd, dtype, device)
    return p, a


def _qkv(p, cfg: ModelConfig, x, positions):
    B, S, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = dense(p["wq"], x).reshape(B, S, h, hd)
    k = dense(p["wk"], x).reshape(B, S, kv, hd)
    v = dense(p["wv"], x).reshape(B, S, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["qnorm"], q, cfg.norm_eps)
        k = rmsnorm(p["knorm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa_inner(qh, kc, vc, causal: bool, q_pos, scale: float):
    """Online softmax over KV chunks.  qh: (B,Sq,KV,g,D); kc/vc: lists of
    (B,Ck,KV,D) chunks; q_pos: (Sq,) global query positions.  Scores,
    running max, sum and accumulator in float32; the probabilities are
    rounded to V's dtype before the AV product (the reference's default
    "bf16" accumulation mode, its products accumulated in float32)."""
    B, Sq, KV, groups, D = qh.shape
    Ck = kc[0].shape[1]
    q32 = qh.float()
    m = torch.full((B, Sq, KV, groups), -math.inf, dtype=torch.float32,
                   device=qh.device)
    l = torch.zeros((B, Sq, KV, groups), dtype=torch.float32,
                    device=qh.device)
    acc = torch.zeros((B, Sq, KV, groups, D), dtype=torch.float32,
                      device=qh.device)
    for idx, (kb, vb) in enumerate(zip(kc, vc)):
        s = torch.einsum("bqkgd,bckd->bqkgc", q32, kb.float()) * scale
        if causal:
            k_pos = idx * Ck + torch.arange(Ck, device=qh.device)
            mask = q_pos[:, None] >= k_pos[None, :]                 # (Sq,Ck)
            s = s.masked_fill(~mask[None, :, None, None, :], -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows (m_new = -inf): keep exp at 0
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p_ = torch.exp(s - m_safe[..., None])
        p_ = torch.where(torch.isfinite(s), p_, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p_.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqkgc,bckd->bqkgd", p_.to(vb.dtype).float(), vb.float())
        m = m_new
    return acc / torch.clamp(l[..., None], min=1e-20)


def _sdpa(q, k, v, causal: bool, q_offset: int = 0):
    """Chunked attention (q and kv both chunked; a chunk length applies
    only where it divides the sequence, as in the reference).

    q: (B,Sq,H,D); k,v: (B,Sk,KV,D).  Never holds more than a (Cq, Ck)
    score block per (batch, head).
    """
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    groups = H // KV
    scale = 1.0 / math.sqrt(D)

    nk = max(1, Sk // ATTN_CHUNK_K) if Sk % ATTN_CHUNK_K == 0 else 1
    nq = max(1, Sq // ATTN_CHUNK_Q) if Sq % ATTN_CHUNK_Q == 0 else 1
    kc = k.chunk(nk, dim=1)
    vc = v.chunk(nk, dim=1)

    Cq = Sq // nq
    qh = q.reshape(B, Sq, KV, groups, D)
    outs = []
    for idx in range(nq):
        q_pos = q_offset + idx * Cq + torch.arange(Cq, device=q.device)
        outs.append(_sdpa_inner(qh[:, idx * Cq:(idx + 1) * Cq], kc, vc,
                                causal, q_pos, scale))
    out = outs[0] if nq == 1 else torch.cat(outs, dim=1)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def gqa_train(p, cfg: ModelConfig, x, *, causal: bool = True):
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(p, cfg, x, positions)
    out = _sdpa(q, k, v, causal=causal)
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
    return dense(p["wo"], out)


def gqa_prefill(p, cfg: ModelConfig, x):
    """Returns (output, cache) — cache = (k, v) over the full prefix."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(p, cfg, x, positions)
    out = _sdpa(q, k, v, causal=True)
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
    return dense(p["wo"], out), {"k": k, "v": v}


def gqa_decode(p, cfg: ModelConfig, x, cache, index: int):
    """x: (B, 1, d); cache k/v: (B, S_max, KV, D), written in place at
    ``index``; keys ``<= index`` are attended, the softmax taken in
    float32 (``attention.py:193-214``)."""
    B = x.shape[0]
    positions = torch.full((B, 1), index, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(p, cfg, x, positions)
    k, v = cache["k"], cache["v"]
    k[:, index:index + 1] = k_new
    v[:, index:index + 1] = v_new
    S_max = k.shape[1]
    groups = cfg.num_heads // cfg.num_kv_heads
    qh = q.reshape(B, 1, cfg.num_kv_heads, groups, cfg.head_dim)
    s = torch.einsum("bqkgd,bskd->bqkgs", qh, k.to(q.dtype))
    s = s / math.sqrt(cfg.head_dim)
    valid = torch.arange(S_max, device=x.device) <= index
    s = s.masked_fill(~valid, -math.inf)
    w = torch.softmax(s.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bqkgs,bskd->bqkgd", w, v.to(q.dtype))
    out = out.reshape(B, 1, cfg.num_heads * cfg.head_dim)
    return dense(p["wo"], out), {"k": k, "v": v}


class Attention(ParamTree):
    """One GQA mixer's weights (``wq``, ``wk``, ``wv``, ``wo``, optional
    ``qnorm``/``knorm``), keyed as the reference's params tree."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, x, causal: bool = True):
        return gqa_train(self, self.cfg, x, causal=causal)

    def prefill(self, x):
        return gqa_prefill(self, self.cfg, x)

    def decode(self, x, cache, index: int):
        return gqa_decode(self, self.cfg, x, cache, index)


# ---------------------------------------------------------------------------
# later slice: cross-attention (whisper) and MLA (deepseek-v3)
# ---------------------------------------------------------------------------


def _later(name: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet: {LATER_SLICE}")
    refuse.__name__ = name
    refuse.__doc__ = f"Not ported yet: {LATER_SLICE}."
    return refuse


gqa_cross = _later("gqa_cross")
cross_kv = _later("cross_kv")
mla_init = _later("mla_init")
mla_train = _later("mla_train")
mla_prefill = _later("mla_prefill")
mla_decode = _later("mla_decode")
