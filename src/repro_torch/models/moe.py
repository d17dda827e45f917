"""Mixture-of-Experts: top-k routing, capacity-based dispatch, shared
experts — the reference's ``models/moe.py`` on PyTorch, its off-mesh path
(``_moe_global``).

Routing in float32: softmax over the router's logits, the top k with the
lower expert id first among equal probabilities (``jax.lax.top_k``'s
order), gates renormalised over the k.  Dispatch sorts the token-choices
by expert (a stable sort), gives each expert ``cap`` slots in arrival
order and gathers the slots' tokens into an ``(E, cap, d)`` buffer; the
expert FFNs run as stacked einsums over E; the combine is k ordered
gathers with the gate weights (no ``index_add_``, whose order of additions
on CUDA is not fixed).

One difference from the reference, on purpose (ROADMAP Queue 3): every
token-choice below its expert's ``cap`` keeps its slot.  The reference
writes the dropped choices onto slot ``cap - 1`` too, as a pad, and on the
CPU the last write of a repeated index wins, so an expert that overflows
gives nothing to the token in its last slot
(``tests/test_torch_moe.py::test_overflow_keeps_every_slot_below_cap``).

The expert-parallel ``shard_map`` paths of the reference (``_moe_sharded``,
``_local_expert_pass``, ``_moe_decode_stationary``) belong to a multi-card
slice (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import (ParamTree, Params, dense_init, mlp, mlp_init, normal)


def moe_init(gen, cfg: ModelConfig, dtype, device=None):
    m = cfg.moe
    d = cfg.d_model
    mult_names = ["wi", "wg", "wo"] if cfg.mlp == "swiglu" else ["wi", "wo"]
    p: Params = {}
    a: Params = {}
    p["router"], a["router"] = dense_init(gen, d, m.num_experts, None, None,
                                          dtype, device=device)
    # stacked expert weights: (E, d, ff) / (E, ff, d)
    std_in = 1.0 / math.sqrt(d)
    std_out = 1.0 / math.sqrt(m.d_ff)
    shapes = {"wi": (m.num_experts, d, m.d_ff),
              "wg": (m.num_experts, d, m.d_ff),
              "wo": (m.num_experts, m.d_ff, d)}
    axes = {"wi": ("experts", "fsdp", "expert_ffn"),
            "wg": ("experts", "fsdp", "expert_ffn"),
            "wo": ("experts", "expert_ffn", "fsdp")}
    for name in mult_names:
        std = std_out if name == "wo" else std_in
        p[name] = normal(gen, shapes[name], std, dtype, device)
        a[name] = axes[name]
    if m.num_shared_experts:
        p["shared"], a["shared"] = mlp_init(
            gen, d, m.num_shared_experts * m.shared_d_ff, cfg.mlp, dtype,
            device)
    return p, a


def _expert_ffn(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    """x: (E, C, d) → (E, C, d) with per-expert weights."""
    if kind == "swiglu":
        h = F.silu(torch.einsum("ecd,edf->ecf", x, p["wg"].to(x.dtype)))
        h = h * torch.einsum("ecd,edf->ecf", x, p["wi"].to(x.dtype))
    else:
        h = F.gelu(torch.einsum("ecd,edf->ecf", x, p["wi"].to(x.dtype)),
                   approximate="tanh")
    return torch.einsum("ecf,efd->ecd", h, p["wo"].to(x.dtype))


def capacity(cfg: ModelConfig, T: int) -> int:
    """Slots an expert has for ``T`` tokens: the reference's expression."""
    m = cfg.moe
    return max(1, int(m.capacity_factor * T * m.top_k / m.num_experts))


def route(p: Params, cfg: ModelConfig, xf: torch.Tensor):
    """xf (T, d) → (probs (T, E), gates (T, k), choices (T, k)) in float32:
    the top k by probability, the lower expert id first among equals,
    gates renormalised over the k."""
    logits = xf.float() @ p["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort orders ties by index, as jax.lax.top_k does
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, choices = vals[:, :cfg.moe.top_k], idx[:, :cfg.moe.top_k]
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gates, choices


def moe_apply(p: Params, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (y, aux_loss), the reference's ``_moe_global``."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    E, k = m.num_experts, m.top_k
    cap = capacity(cfg, T)
    probs, gate_vals, choices = route(p, cfg, xf)

    # ---- sort-based slot assignment (indices only) ----------------------
    flat_e = choices.reshape(T * k)                             # expert ids
    flat_tok = torch.arange(T * k, device=x.device) // k        # token ids
    sorted_e, order = torch.sort(flat_e, stable=True)           # group by e
    # counts by a scatter of integer ones: exact in any order, and no
    # device-to-host copy (bincount on CUDA reads the ids' maximum)
    counts = torch.zeros(E, dtype=torch.long, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))                     # (E,)
    starts = torch.cumsum(counts, 0) - counts                   # exclusive
    pos_sorted = torch.arange(T * k, device=x.device) - starts[sorted_e]
    keep_sorted = pos_sorted < cap
    # slot -> token map; pad slots point at the zero row T.  A kept choice
    # writes its own slot; the dropped ones write a trash slot past the
    # end, cut off afterwards, so no kept slot is written twice.
    slot_sorted = torch.where(keep_sorted, sorted_e * cap + pos_sorted,
                              E * cap)
    slot_tok = torch.full((E * cap + 1,), T, dtype=torch.long,
                          device=x.device)
    slot_tok[slot_sorted] = flat_tok[order]
    slot_tok = slot_tok[:E * cap]

    # ---- dispatch (gather), expert FFN, combine (gather) -----------------
    x_pad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    expert_in = x_pad[slot_tok].reshape(E, cap, d)
    expert_out = _expert_ffn(p, expert_in, cfg.mlp).reshape(E * cap, d)

    # inverse permutation: flat entry -> its sorted position
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=x.device)
    pos = pos_sorted[inv]                                       # (T*k,)
    keep = (pos < cap).reshape(T, k)
    slot = (flat_e * cap + torch.clamp(pos, max=cap - 1)).reshape(T, k)
    y = torch.zeros_like(xf)
    for i in range(k):  # k gathers of (T, d), accumulated in order
        contrib = expert_out[slot[:, i]]
        w = (gate_vals[:, i] * keep[:, i]).to(x.dtype)
        y = y + contrib * w[:, None]
    if m.num_shared_experts:
        y = y + mlp(p["shared"], xf, cfg.mlp)

    # load-balancing aux loss (Switch-style)
    frac_tokens = counts.float() / float(T * k)
    frac_probs = probs.mean(dim=0)
    aux = E * torch.sum(frac_tokens * frac_probs) * m.router_aux_weight
    return y.reshape(B, S, d), aux


class MoE(ParamTree):
    """One MoE layer's weights (``router``, stacked ``wi``/``wg``/``wo``,
    optional ``shared``), keyed as the reference's params tree."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, x):
        return moe_apply(self, self.cfg, x)
