"""Mamba2 (SSD — state space duality) token mixer, the reference's
``models/ssm.py`` on PyTorch.

The chunked SSD algorithm of Mamba2: within a chunk the recurrence is a
(Q, Q) lower-triangular decay matrix; chunk boundary states propagate in
a loop over chunks.  Exactly equivalent to the per-token recurrence
(``ssd_reference``, which decode runs).

Recurrence (per head; p = head dim, n = state dim):

    h_t = exp(a_t) h_{t-1} + dt_t · (B_t ⊗ x_t)        a_t = -exp(A_log)·dt_t
    y_t = C_t · h_t + D ⊙ x_t

Decode carries ``(conv (B, conv-1, d_conv_in), state (B, H, p, n))``: the
conv cache in the activation dtype, the state in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..sharding.specs import block_spec, on_blocks, reshape
from .config import ModelConfig
from .layers import (ParamTree, Params, dense, dense_init, normal, rmsnorm,
                     rmsnorm_init, softplus)


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = s.num_heads or d_in // s.head_dim
    return d_in, nheads, s.head_dim, s.state_dim


def mamba2_init(gen, cfg: ModelConfig, dtype, device=None):
    """``A_log``, ``D`` and ``dt_bias`` are float32 whatever ``dtype`` is."""
    s = cfg.ssm
    d = cfg.d_model
    d_in, H, P, N = _dims(cfg)
    conv_dim = d_in + 2 * N
    p: Params = {}
    a: Params = {}
    # in_proj → [z (d_in), xBC (d_in + 2N), dt (H)]
    p["in_proj"], a["in_proj"] = dense_init(
        gen, d, 2 * d_in + 2 * N + H, None, "heads", dtype, device=device)
    p["conv_w"] = normal(gen, (s.conv_width, conv_dim), 1.0 / s.conv_width,
                         dtype, device)
    a["conv_w"] = ("conv", "heads")
    p["conv_b"] = torch.zeros((conv_dim,), dtype=dtype, device=device)
    a["conv_b"] = ("heads",)
    p["A_log"] = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                          device=device))
    a["A_log"] = ("heads",)
    p["D"] = torch.ones((H,), dtype=torch.float32, device=device)
    a["D"] = ("heads",)
    p["dt_bias"] = torch.zeros((H,), dtype=torch.float32, device=device)
    a["dt_bias"] = ("heads",)
    p["norm"], a["norm"] = rmsnorm_init(d_in, dtype, device)
    p["out_proj"], a["out_proj"] = dense_init(gen, d_in, d, "heads", None,
                                              dtype, device=device)
    return p, a


def _split_proj(cfg, proj):
    d_in, H, P, N = _dims(cfg)
    z = proj[..., :d_in]
    xBC = proj[..., d_in:2 * d_in + 2 * N]
    dt = proj[..., 2 * d_in + 2 * N:]
    return z, xBC, dt


def _causal_conv(cfg, xBC, conv_w, conv_b, cache=None):
    """Depthwise causal conv (width K) via explicit shifts.

    xBC (B, S, Cd); cache (B, K-1, Cd) holds the previous K-1 inputs.
    Returns (out, new_cache).
    """
    K = cfg.ssm.conv_width
    B, S, Cd = xBC.shape
    if cache is None:
        cache = xBC.new_zeros((B, K - 1, Cd))
    ext = torch.cat([cache, xBC], dim=1)                 # (B, S+K-1, Cd)
    out = torch.zeros_like(xBC)
    for i in range(K):  # static unroll; K = 4
        out = out + ext[:, i:i + S, :] * conv_w[i][None, None, :]
    out = F.silu(out + conv_b[None, None, :])
    new_cache = ext[:, -(K - 1):, :]   # last K-1 raw inputs
    return out, new_cache


def _on_head_blocks(fn, cfg, xh, dt, Bm, Cm, A_log, D, state):
    """``fn`` on DTensors on each rank's blocks of the batch and the heads
    (``Bm`` and ``Cm`` are shared by every head: whole on them)."""
    sx = block_spec(xh, ("batch", None, "heads", None))
    b, hd = sx[0], sx[2]
    ss = (b, hd, None, None)
    return on_blocks(lambda *a: fn(cfg, *a),
                     (xh, dt, Bm, Cm, A_log, D, state),
                     (sx, (b, None, hd), (b, None, None), (b, None, None),
                      (hd,), (hd,), ss), (sx, ss))


def ssd_reference(cfg: ModelConfig, xh, dt, Bm, Cm, A_log, D, state=None):
    """Per-token recurrence (decode's path, and the oracle of
    :func:`ssd_chunked`).

    xh (B,S,H,P) | dt (B,S,H) | Bm,Cm (B,S,N) | state (B,H,P,N)
    """
    return _on_head_blocks(_ssd_reference_local, cfg, xh, dt, Bm, Cm,
                           A_log, D, state)


def ssd_chunked(cfg: ModelConfig, xh, dt, Bm, Cm, A_log, D, state=None):
    """Chunked SSD — same I/O contract as :func:`ssd_reference`."""
    return _on_head_blocks(_ssd_chunked_local, cfg, xh, dt, Bm, Cm, A_log,
                           D, state)


def _ssd_reference_local(cfg: ModelConfig, xh, dt, Bm, Cm, A_log, D,
                         state=None):
    """Per-token recurrence (decode's path, and the oracle of
    :func:`ssd_chunked`).

    xh (B,S,H,P) | dt (B,S,H) | Bm,Cm (B,S,N) | state (B,H,P,N)
    """
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    A = -torch.exp(A_log)                                 # (H,)
    if state is None:
        state = torch.zeros((B, H, P, N), dtype=torch.float32,
                            device=xh.device)
    x32, b32, c32 = xh.float(), Bm.float(), Cm.float()
    h, ys = state, []
    for t in range(S):
        x_t, dt_t, b_t, c_t = x32[:, t], dt[:, t], b32[:, t], c32[:, t]
        decay = torch.exp(A[None, :] * dt_t)              # (B,H)
        upd = torch.einsum("bhp,bn->bhpn", x_t * dt_t[..., None], b_t)
        h = h * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, c_t))
    y = torch.stack(ys, dim=1) + x32 * D[None, None, :, None]
    return y, h


def _ssd_chunked_local(cfg: ModelConfig, xh, dt, Bm, Cm, A_log, D,
                       state=None):
    """Chunked SSD — same I/O contract as :func:`ssd_reference`."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = cfg.ssm.chunk
    if S % Q != 0:
        Q = S  # degenerate single chunk (prompts shorter than a chunk)
    nC = S // Q
    A = -torch.exp(A_log)

    xh = xh.float().reshape(B, nC, Q, H, P)
    dtc = dt.reshape(B, nC, Q, H)
    Bc = Bm.float().reshape(B, nC, Q, N)
    Cc = Cm.float().reshape(B, nC, Q, N)

    a = A[None, None, None, :] * dtc                       # (B,nC,Q,H) ≤ 0
    cum = torch.cumsum(a, dim=2)                           # inclusive
    # intra-chunk: M[t,s] = C_t·B_s · exp(cum_t - cum_s) · dt_s   (s ≤ t)
    cb = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)           # (B,nC,Q,Q)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nC,Q,Q,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    # mask BEFORE exp: diff > 0 above the diagonal would overflow
    diff = diff.masked_fill(~tri[None, None, :, :, None], -math.inf)
    decay = torch.exp(diff)
    M = cb[..., None] * decay * dtc[:, :, None, :, :]      # (B,nC,Q,Q,H)
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", M, xh)

    # chunk summary state: S_c = Σ_s exp(cum_Q - cum_s) dt_s B_s ⊗ x_s
    tail = torch.exp(cum[:, :, -1:, :] - cum)              # (B,nC,Q,H)
    Ssum = torch.einsum("bcqh,bcqn,bcqhp->bchpn",
                        tail * dtc, Bc, xh)                # (B,nC,H,P,N)
    chunk_decay = torch.exp(a.sum(dim=2))                  # (B,nC,H)

    if state is None:
        state = torch.zeros((B, H, P, N), dtype=torch.float32,
                            device=xh.device)
    h, hs = state, []
    for c in range(nC):
        hs.append(h)                                       # state BEFORE chunk
        h = h * chunk_decay[:, c, :, None, None] + Ssum[:, c]
    h_prev = torch.stack(hs, dim=1)                        # (B,nC,H,P,N)

    # inter-chunk: y_t += C_t · (exp(cum_t) h_prev)
    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp",
                           Cc, torch.exp(cum), h_prev)
    y = (y_intra + y_inter).reshape(B, S, H, P)
    y = y + xh.reshape(B, S, H, P) * D[None, None, :, None]
    return y, h


def _mix(p: Params, cfg: ModelConfig, x, conv_cache, ssd, state):
    """in_proj → causal conv → SSD → gated norm → out_proj; returns
    (output, conv cache, state)."""
    d_in, H, P, N = _dims(cfg)
    B, S, _ = x.shape
    proj = dense(p["in_proj"], x)
    z, xBC, dt = _split_proj(cfg, proj)
    xBC, conv_cache = _causal_conv(cfg, xBC, p["conv_w"].to(x.dtype),
                                   p["conv_b"].to(x.dtype), cache=conv_cache)
    xh = reshape(xBC[..., :d_in], B, S, H, P)
    Bm = xBC[..., d_in:d_in + N]
    Cm = xBC[..., d_in + N:]
    dt = softplus(dt.float() + p["dt_bias"][None, None, :])
    y, state = ssd(cfg, xh, dt, Bm, Cm, p["A_log"], p["D"], state=state)
    y = reshape(y, B, S, d_in).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return dense(p["out_proj"], y), conv_cache, state


def mamba2_train(p: Params, cfg: ModelConfig, x: torch.Tensor
                 ) -> torch.Tensor:
    return _mix(p, cfg, x, None, ssd_chunked, None)[0]


def mamba2_prefill(p: Params, cfg: ModelConfig, x: torch.Tensor):
    out, conv, state = _mix(p, cfg, x, None, ssd_chunked, None)
    return out, {"conv": conv, "state": state}


def mamba2_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, cache,
                  index: int):
    """Single-token state update.  x: (B, 1, d)."""
    out, conv, state = _mix(p, cfg, x, cache["conv"], ssd_reference,
                            cache["state"])
    return out, {"conv": conv, "state": state}


class Mamba2(ParamTree):
    """One Mamba2 mixer's weights, keyed as the reference's params tree."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, x):
        return mamba2_train(self, self.cfg, x)

    def prefill(self, x):
        return mamba2_prefill(self, self.cfg, x)

    def decode(self, x, cache, index: int):
        return mamba2_decode(self, self.cfg, x, cache, index)
