"""Attention: GQA (RoPE, qk-norm, qkv-bias), cross-attention (Whisper)
and MLA (DeepSeek-V3), the reference's ``models/attention.py`` on PyTorch.

Three entry points per variant:

* ``*_train``   — full-sequence causal (or bidirectional) attention, an
  online softmax over KV chunks (a Python loop over chunks), so the score
  matrix is never fully materialized for long sequences;
* ``*_prefill`` — the train-path forward that also returns the KV cache;
* ``*_decode``  — one query token against a KV cache, written in place.

Cross-attention (``gqa_cross``) attends, without RoPE and without a causal
mask, to keys and values that ``cross_kv`` projects once from the
encoder's output.  MLA caches only the compressed latent (``c_kv``, after
its norm, and the shared ``k_rope``, after RoPE); its decode either folds
``W_uk`` into the query and attends in latent space (``absorbed=True``,
the reference's default) or expands the latent to per-head K/V.

Plain PyTorch ops only (``torch.einsum``, ``softmax``).  On DTensors
(state placed over a mesh) attention runs on each rank's local blocks
(``sharding.specs.on_blocks``): training and prefill over the blocks of
the batch and the heads that the rules give queries and keys alike,
decode over the blocks of the batch and of the cache's sequence (split
over ``model`` under ``DECODE_RULES``), the softmax's max and sum and the
weighted values reduced over the ranks that split the sequence.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

import torch.distributed as dist

from ..sharding import with_logical_constraint as wlc
from ..sharding.specs import (block_offset, block_spec, on_blocks, reshape,
                              write_at)
from .config import ModelConfig
from .layers import (ParamTree, apply_rope, dense, dense_init, rmsnorm,
                     rmsnorm_init)

ATTN_CHUNK_Q = 1024  # query chunk for online-softmax attention
ATTN_CHUNK_K = 2048  # KV chunk


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
    q = reshape(dense(p["wq"], x), B, S, h, hd)
    k = reshape(dense(p["wk"], x), B, S, kv, hd)
    v = reshape(dense(p["wv"], x), B, S, kv, hd)
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


def _sdpa_local(q, k, v, causal: bool, q_offset: int = 0):
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


def _sdpa(q, k, v, causal: bool, q_offset: int = 0):
    """:func:`_sdpa_local`; on DTensors on each rank's blocks of the
    batch and of the heads that the rules split (the reference's
    constraints, ``attention.py:176-177``).  Where they split the query
    heads but not the key heads alike, the keys stay whole on their heads
    and each rank reads the key heads of its query heads (when these fill
    whole groups, or lie in one); else the heads stay whole."""
    sq = block_spec(q, ("batch", None, "heads", None))
    sk = block_spec(k, ("batch", None, "kv_heads", None))
    whole = (sq[0], None, None, None)
    if sq[2] == sk[2]:
        spec = (sq[0], None, sq[2], None)
        return on_blocks(lambda *a: _sdpa_local(*a, causal, q_offset),
                         (q, k, v), (spec, spec, spec), spec)
    H, KV = q.shape[2], k.shape[2]
    g, n = H // KV, H // _local_size(q, sq, 2)
    if n > 1 and (H // n % g == 0 or g % (H // n) == 0):
        spec = (sq[0], None, sq[2], None)
        lo, kv_n = block_offset(q, spec, 2) // g, max(1, H // n // g)

        def fn(q, k, v):
            return _sdpa_local(q, k.narrow(2, lo, kv_n),
                               v.narrow(2, lo, kv_n), causal, q_offset)
        return on_blocks(fn, (q, k, v), (spec, whole, whole), spec)
    return on_blocks(lambda *a: _sdpa_local(*a, causal, q_offset),
                     (q, k, v), (whole, whole, whole), whole)


def _local_size(x, spec, dim: int) -> int:
    """The length of this rank's block of ``x``'s dim ``dim`` under
    ``spec`` (the whole length for a plain tensor)."""
    if spec[dim] is None:
        return x.shape[dim]
    mesh = x.device_mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    e = spec[dim]
    names = (e,) if isinstance(e, str) else e
    return x.shape[dim] // math.prod(sizes[a] for a in names)


def _seq_groups(x, spec, dim: int) -> list:
    """The process groups of the mesh axes of more than one rank that
    ``spec`` splits ``x``'s dim ``dim`` over (none for a plain tensor)."""
    e = spec[dim]
    if e is None:
        return []
    mesh = x.device_mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    names = (e,) if isinstance(e, str) else e
    return [mesh.get_group(n) for n in names if sizes[n] > 1]


def _attend(s, av, groups):
    """``av(w)``, ``w`` the float32 softmax of the scores ``s`` over their
    last dim.  Where that dim (the cache's sequence) is split over the
    ranks of ``groups``, the softmax's max and sum, and ``av``'s partial
    products, are reduced over them."""
    if not groups:
        return av(torch.softmax(s.float(), dim=-1))
    s = s.float()
    m = s.amax(dim=-1, keepdim=True)
    for g in groups:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
    p = torch.exp(s - m)
    l_ = p.sum(dim=-1, keepdim=True)
    for g in groups:
        dist.all_reduce(l_, group=g)
    out = av(p / l_)
    for g in groups:
        dist.all_reduce(out, group=g)
    return out


def gqa_train(p, cfg: ModelConfig, x, *, causal: bool = True):
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(p, cfg, x, positions)
    q = wlc(q, ("batch", None, "heads", "head_dim"))
    k = wlc(k, ("batch", None, "kv_heads", "head_dim"))
    out = _sdpa(q, k, v, causal=causal)
    out = reshape(out, B, S, cfg.num_heads * cfg.head_dim)
    return dense(p["wo"], out)


def gqa_prefill(p, cfg: ModelConfig, x):
    """Returns (output, cache) — cache = (k, v) over the full prefix."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(p, cfg, x, positions)
    out = _sdpa(q, k, v, causal=True)
    out = reshape(out, B, S, cfg.num_heads * cfg.head_dim)
    return dense(p["wo"], out), {"k": k, "v": v}


def gqa_decode(p, cfg: ModelConfig, x, cache, index: int):
    """x: (B, 1, d); cache k/v: (B, S_max, KV, D), written in place at
    ``index``; keys ``<= index`` are attended, the softmax taken in
    float32 (``attention.py:193-214``)."""
    B = x.shape[0]
    positions = torch.full((B, 1), index, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(p, cfg, x, positions)
    k, v = cache["k"], cache["v"]
    write_at(k, 1, index, k_new)
    write_at(v, 1, index, v_new)
    k = wlc(k, ("batch", "cache_seq", "kv_heads", "head_dim"))
    v = wlc(v, ("batch", "cache_seq", "kv_heads", "head_dim"))
    # the cache keeps its split over the sequence (DECODE_RULES); the
    # queries are whole over the axes that split it
    sk = block_spec(k, ("batch", "cache_seq", None, None))
    sq = (sk[0], None, None, None)
    off, groups = block_offset(k, sk, 1), _seq_groups(k, sk, 1)

    def attend(q, k, v):
        Bl, _, H, D = q.shape
        KV = k.shape[2]
        qh = q.reshape(Bl, 1, KV, H // KV, D)
        s = torch.einsum("bqkgd,bskd->bqkgs", qh, k.to(q.dtype))
        s = s / math.sqrt(cfg.head_dim)
        valid = off + torch.arange(k.shape[1], device=q.device) <= index
        s = s.masked_fill(~valid, -math.inf)
        out = _attend(s, lambda w: torch.einsum(
            "bqkgs,bskd->bqkgd", w.to(q.dtype), v.to(q.dtype)), groups)
        return out.reshape(Bl, 1, H, D)
    out = on_blocks(attend, (q, k, v), (sq, sk, sk), sq)
    out = reshape(out, B, 1, cfg.num_heads * cfg.head_dim)
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


def gqa_cross(p, cfg: ModelConfig, x, enc_kv):
    """Cross-attention against precomputed encoder K/V (Whisper's
    decoder): queries from ``wq``, no RoPE, no mask."""
    B, S, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q = reshape(dense(p["wq"], x), B, S, h, hd)
    out = _sdpa(q, enc_kv["k"], enc_kv["v"], causal=False)
    out = reshape(out, B, S, h * hd)
    return dense(p["wo"], out)


def cross_kv(p, cfg: ModelConfig, enc_out):
    """The encoder output's keys and values (B, S_enc, KV, D), no RoPE."""
    B, S, _ = enc_out.shape
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    k = reshape(dense(p["wk"], enc_out), B, S, kv, hd)
    v = reshape(dense(p["wv"], enc_out), B, S, kv, hd)
    return {"k": k, "v": v}


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, deepseek-v3)
# ---------------------------------------------------------------------------


def mla_init(gen, cfg: ModelConfig, dtype, device=None):
    d, h = cfg.d_model, cfg.num_heads
    hd, rd, vd = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    p, a = {}, {}
    p["wq_a"], a["wq_a"] = dense_init(gen, d, qr, None, None, dtype,
                                      device=device)
    p["qnorm"], a["qnorm"] = rmsnorm_init(qr, dtype, device)
    p["wq_b"], a["wq_b"] = dense_init(gen, qr, h * (hd + rd), None, "heads",
                                      dtype, device=device)
    p["wkv_a"], a["wkv_a"] = dense_init(gen, d, kvr + rd, None, None, dtype,
                                        device=device)
    p["kvnorm"], a["kvnorm"] = rmsnorm_init(kvr, dtype, device)
    p["wkv_b"], a["wkv_b"] = dense_init(gen, kvr, h * (hd + vd), None,
                                        "heads", dtype, device=device)
    p["wo"], a["wo"] = dense_init(gen, h * vd, d, "heads", None, dtype,
                                  device=device)
    return p, a


def _mla_q(p, cfg, x, positions):
    B, S, _ = x.shape
    h, hd, rd = cfg.num_heads, cfg.head_dim, cfg.rope_head_dim
    q = dense(p["wq_b"], rmsnorm(p["qnorm"], dense(p["wq_a"], x),
                                 cfg.norm_eps))
    q = reshape(q, B, S, h, hd + rd)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(p, cfg, x, positions):
    """(c_kv (B, S, kvr) after ``kvnorm``, k_rope (B, S, rd) after RoPE,
    which takes it through a head axis of one)."""
    kvr = cfg.kv_lora_rank
    kv = dense(p["wkv_a"], x)                       # (B, S, kvr + rd)
    c_kv = rmsnorm(p["kvnorm"], kv[..., :kvr], cfg.norm_eps)
    k_rope = apply_rope(kv[..., kvr:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _mla_expand(p, cfg, c_kv):
    """Latent → per-head K(nope)/V. (B, S, kvr) → (B, S, H, hd)+(B, S, H, vd)."""
    B, S, _ = c_kv.shape
    h, hd, vd = cfg.num_heads, cfg.head_dim, cfg.v_head_dim
    kvb = reshape(dense(p["wkv_b"], c_kv), B, S, h, hd + vd)
    return kvb[..., :hd], kvb[..., hd:]


def _mla_attend(cfg, q_nope, q_rope, k_nope, k_rope, v):
    """Causal MLA attention through :func:`_sdpa_local` on concatenated
    heads: q = [q_nope; q_rope], k = [k_nope; k_rope on every head], so
    the scale is 1/√(hd + rd); v is zero-padded from vd to hd + rd and the
    result sliced back to vd.  On DTensors on each rank's blocks of the
    batch and the heads (``k_rope`` is shared by every head)."""
    sq = block_spec(q_nope, ("batch", None, "heads", None))
    sr = (sq[0], None, None)
    return on_blocks(_mla_attend_local, (q_nope, q_rope, k_nope, k_rope, v),
                     (sq, sq, sq, sr, sq), sq)


def _mla_attend_local(q_nope, q_rope, k_nope, k_rope, v):
    B, Sq, H, hd = q_nope.shape
    vd = v.shape[-1]
    rd = q_rope.shape[-1]
    k_rope_h = k_rope[:, :, None, :].expand(B, k_rope.shape[1], H, rd)
    q_eff = torch.cat([q_nope, q_rope], dim=-1)
    k_eff = torch.cat([k_nope, k_rope_h], dim=-1)
    D_eff = hd + rd
    v_pad = F.pad(v, [0, D_eff - vd]) if vd < D_eff else v
    out = _sdpa_local(q_eff, k_eff, v_pad, causal=True)
    return out[..., :vd]


def _mla_forward(p, cfg: ModelConfig, x):
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_latent(p, cfg, x, positions)
    k_nope, v = _mla_expand(p, cfg, c_kv)
    out = _mla_attend(cfg, q_nope, q_rope, k_nope, k_rope, v)
    out = reshape(out, B, S, cfg.num_heads * cfg.v_head_dim)
    return dense(p["wo"], out), {"c_kv": c_kv, "k_rope": k_rope}


def mla_train(p, cfg: ModelConfig, x):
    return _mla_forward(p, cfg, x)[0]


def mla_prefill(p, cfg: ModelConfig, x):
    """Returns (output, cache) — cache = the latent ``c_kv`` and
    ``k_rope`` over the full prefix."""
    return _mla_forward(p, cfg, x)


def mla_decode(p, cfg: ModelConfig, x, cache, index: int, *,
               absorbed: bool = True):
    """MLA decode against the latent cache, written in place at ``index``.

    ``absorbed=True`` folds ``W_uk`` into the query (score = (q W_uk) ·
    c_kv) and attends in latent space, then applies ``W_uv``; ``False``
    expands the whole cache to per-head K/V.  Both scale the scores by
    1/√(hd + rd) and take the softmax in float32."""
    B = x.shape[0]
    h, hd, vd = cfg.num_heads, cfg.head_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    positions = torch.full((B, 1), index, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)          # (B,1,H,hd/rd)
    c_new, kr_new = _mla_latent(p, cfg, x, positions)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    write_at(c_kv, 1, index, c_new)
    write_at(k_rope, 1, index, kr_new)
    c_kv = wlc(c_kv, ("batch", "cache_seq", None))
    scale = 1.0 / math.sqrt(hd + cfg.rope_head_dim)
    # the cache keeps its split over the sequence (DECODE_RULES); the
    # queries and W_kv_b are whole over the axes that split it
    sc = block_spec(c_kv, ("batch", "cache_seq", None))
    sq = (sc[0], None, None, None)
    off, groups = block_offset(c_kv, sc, 1), _seq_groups(c_kv, sc, 1)
    dt = x.dtype

    def attend(q_nope, q_rope, c_kv, k_rope, w):
        Bl, S_l = c_kv.shape[:2]
        wkv_b = w.to(dt).reshape(kvr, h, hd + vd)
        w_uk = wkv_b[..., :hd]                              # (kvr, H, hd)
        w_uv = wkv_b[..., hd:]                              # (kvr, H, vd)
        c_x, kr_x = c_kv.to(dt), k_rope.to(dt)
        if absorbed:
            q_lat = torch.einsum("bqhd,chd->bqhc", q_nope, w_uk)
            s = (torch.einsum("bqhc,bsc->bhqs", q_lat, c_x) +
                 torch.einsum("bqhd,bsd->bhqs", q_rope, kr_x))
        else:
            kvb = (c_x @ w.to(dt)).reshape(Bl, S_l, h, hd + vd)
            s = (torch.einsum("bqhd,bshd->bhqs", q_nope, kvb[..., :hd]) +
                 torch.einsum("bqhd,bsd->bhqs", q_rope, kr_x))
        s = s * scale
        valid = off + torch.arange(S_l, device=c_kv.device) <= index
        s = s.masked_fill(~valid, -math.inf)
        if absorbed:
            o_lat = _attend(s, lambda w_: torch.einsum(
                "bhqs,bsc->bqhc", w_.to(dt), c_x), groups)
            return torch.einsum("bqhc,chd->bqhd", o_lat, w_uv)
        return _attend(s, lambda w_: torch.einsum(
            "bhqs,bshd->bqhd", w_.to(dt), kvb[..., hd:]), groups)
    out = on_blocks(attend, (q_nope, q_rope, c_kv, k_rope,
                             p["wkv_b"]["w"]),
                    (sq, sq, sc, sc, (None, None)), sq)   # (B,1,H,vd)
    out = reshape(out, B, 1, h * vd)
    return dense(p["wo"], out), {"c_kv": c_kv, "k_rope": k_rope}


class MLA(ParamTree):
    """One MLA mixer's weights (``wq_a``, ``qnorm``, ``wq_b``, ``wkv_a``,
    ``kvnorm``, ``wkv_b``, ``wo``), keyed as the reference's params tree.
    ``absorbed`` picks the decode form (the reference's default, True)."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg
        self.absorbed = True

    def forward(self, x):
        return mla_train(self, self.cfg, x)

    def prefill(self, x):
        return mla_prefill(self, self.cfg, x)

    def decode(self, x, cache, index: int):
        return mla_decode(self, self.cfg, x, cache, index,
                          absorbed=self.absorbed)
