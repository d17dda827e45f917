"""RWKV-6 (Finch) token mixer: token shift + data-dependent decay WKV, the
reference's ``models/rwkv.py`` on PyTorch.

Per head (size N), with receptance r, key k, value v, decay w ∈ (0,1), bonus u:

    y_t = r_t · (S_{t-1} + diag(u) k_t vᵀ_t)
    S_t = diag(w_t) S_{t-1} + k_t vᵀ_t

The decay is *data-dependent*: w_t = exp(-exp(w0 + LoRA(lerp(x_t,
x_{t-1})))), in float32.  Token shift mixes each projection's input with
the previous token.  The recurrence runs as a loop over positions in
float32; decode carries ``x_prev (B, 1, d)`` and ``state (B, H, N, N)``.
The channel mix (squared-ReLU FFN) lives in the stack's MLP slot
(:func:`repro_torch.models.stack.channel_mix`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..sharding.specs import block_spec, on_blocks, reshape
from .config import ModelConfig
from .layers import ParamTree, Params, dense, dense_init, rmsnorm, \
    rmsnorm_init

LORA_R = 64
HEAD = 64  # rwkv6 head size


def _dims(cfg: ModelConfig):
    H = cfg.d_model // HEAD
    return H, HEAD


def rwkv6_init(gen, cfg: ModelConfig, dtype, device=None):
    """``w0`` and ``u`` are float32 whatever ``dtype`` is."""
    d = cfg.d_model
    H, N = _dims(cfg)
    p: Params = {}
    a: Params = {}
    for name in ("wr", "wk", "wv", "wg", "wo"):
        in_ax, out_ax = ("heads", None) if name == "wo" else (None, "heads")
        p[name], a[name] = dense_init(gen, d, d, in_ax, out_ax, dtype,
                                      device=device)
    # static token-shift lerp weights per projection
    for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
        p[name] = torch.full((d,), 0.5, dtype=dtype, device=device)
        a[name] = (None,)
    # data-dependent decay LoRA
    p["w0"] = torch.full((d,), -0.6, dtype=torch.float32, device=device)
    a["w0"] = (None,)
    p["w_lora_a"], a["w_lora_a"] = dense_init(gen, d, LORA_R, None, None,
                                              dtype, device=device)
    p["w_lora_b"], a["w_lora_b"] = dense_init(gen, LORA_R, d, None, None,
                                              dtype, device=device)
    p["u"] = torch.zeros((H, N), dtype=torch.float32, device=device)
    a["u"] = ("heads", None)
    p["ln_x"], a["ln_x"] = rmsnorm_init(d, dtype, device)
    return p, a


def _shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Previous-token tensor: (B,S,d) with x_prev (B,1,d) as position -1."""
    return torch.cat([x_prev, x[:, :-1, :]], dim=1)


def _wkv_scan(r, k, v, w, u, state):
    """r,k,v,w: (B,S,H,N); u: (H,N); state: (B,H,N,N) → (y, state); over
    DTensors on each rank's blocks of the batch and the heads."""
    sr = block_spec(r, ("batch", None, "heads", None))
    ss = (sr[0], sr[2], None, None)
    return on_blocks(_wkv_loop, (r, k, v, w, state, u),
                     (sr, sr, sr, sr, ss, (sr[2], None)), (sr, ss))


def _wkv_loop(r, k, v, w, state, u):
    # each position's (B,H,N) slices, and u's broadcast, made once
    u4 = u[None, :, :, None]
    ys = []
    for r_t, k_t, v_t, w_t in zip(r.unbind(1), k.unbind(1), v.unbind(1),
                                  w[..., None].unbind(1)):
        kv = torch.einsum("bhk,bhv->bhkv", k_t, v_t)         # (B,H,N,N)
        ys.append(torch.einsum("bhk,bhkv->bhv", r_t, state + u4 * kv))
        state = w_t * state + kv
    return torch.stack(ys, dim=1), state                           # (B,S,H,N)


def _projections(p, cfg, x, x_shift):
    B, S, d = x.shape
    H, N = _dims(cfg)

    def lerp(mu):
        m = p[mu].to(x.dtype)[None, None, :]
        return x * (1 - m) + x_shift * m

    r = reshape(dense(p["wr"], lerp("mu_r")), B, S, H, N)
    k = reshape(dense(p["wk"], lerp("mu_k")), B, S, H, N)
    v = reshape(dense(p["wv"], lerp("mu_v")), B, S, H, N)
    g = F.silu(dense(p["wg"], lerp("mu_g")))
    w_in = lerp("mu_w")
    w_raw = p["w0"][None, None, :] + dense(
        p["w_lora_b"], torch.tanh(dense(p["w_lora_a"], w_in))).float()
    w = reshape(torch.exp(-torch.exp(w_raw)), B, S, H, N)  # data-dependent
    return r.float(), k.float(), v.float(), w, g


def _mix(p, cfg, x, x_prev, state):
    """(output, state) of the time mix over x (B,S,d) after ``x_prev``."""
    B, S, d = x.shape
    r, k, v, w, g = _projections(p, cfg, x, _shift(x, x_prev))
    y, state = _wkv_scan(r, k, v, w, p["u"], state)
    y = rmsnorm(p["ln_x"], reshape(y, B, S, d).to(x.dtype), cfg.norm_eps)
    return dense(p["wo"], y * g), state


def _zero_state(cfg, x):
    H, N = _dims(cfg)
    return torch.zeros((x.shape[0], H, N, N), dtype=torch.float32,
                       device=x.device)


def rwkv6_train(p: Params, cfg: ModelConfig, x: torch.Tensor
                ) -> torch.Tensor:
    return _mix(p, cfg, x, x.new_zeros((x.shape[0], 1, x.shape[2])),
                _zero_state(cfg, x))[0]


def rwkv6_prefill(p: Params, cfg: ModelConfig, x: torch.Tensor):
    out, state = _mix(p, cfg, x, x.new_zeros((x.shape[0], 1, x.shape[2])),
                      _zero_state(cfg, x))
    return out, {"x_prev": x[:, -1:, :], "state": state}


def rwkv6_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, cache,
                 index: int):
    """x: (B, 1, d)."""
    out, state = _mix(p, cfg, x, cache["x_prev"], cache["state"])
    return out, {"x_prev": x, "state": state}


class RWKV6(ParamTree):
    """One RWKV6 time mix's weights, keyed as the reference's params
    tree."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, x):
        return rwkv6_train(self, self.cfg, x)

    def prefill(self, x):
        return rwkv6_prefill(self, self.cfg, x)

    def decode(self, x, cache, index: int):
        return rwkv6_decode(self, self.cfg, x, cache, index)
