"""Shared layers: param init helpers, norms, embeddings, RoPE, MLPs.

The reference package's ``models/layers.py`` on PyTorch.  Parameters are
plain dicts of tensors, the same tree as the reference's: every init
function returns ``(params, axes)`` where ``axes`` mirrors the params tree
with tuples of *logical* axis names (kept for the training slice's
sharding; one card needs none).  Weights are stored ``(in, out)`` as in the
reference, so ``dense`` is ``x @ w``.  Each init draws from an explicit
``torch.Generator`` on the tensor's device: normal × scale/√in in float32,
then cast to the parameter dtype, the reference's scheme (not its numbers).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def normal(gen: Optional[torch.Generator], shape, std: float, dtype,
           device) -> torch.Tensor:
    """A float32 normal draw × ``std`` cast to ``dtype``; with no generator
    an uninitialised tensor (weights that a caller loads afterwards)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(std).to(dtype)


def dense_init(gen, in_dim: int, out_dim: int, in_axis: Optional[str],
               out_axis: Optional[str], dtype, bias: bool = False,
               fsdp_axis: Optional[str] = "fsdp", scale: float = 1.0,
               device=None):
    """Linear layer params.  Weight logical axes: (in_axis|fsdp, out_axis)."""
    std = scale / math.sqrt(in_dim)
    axes_in = in_axis if in_axis is not None else fsdp_axis
    axes_out = out_axis if out_axis is not None else (
        fsdp_axis if in_axis is not None else None)
    p = {"w": normal(gen, (in_dim, out_dim), std, dtype, device)}
    a = {"w": (axes_in, axes_out)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=device)
        a["b"] = (out_axis,)
    return p, a


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm_init(dim: int, dtype, device=None):
    return ({"scale": torch.ones((dim,), dtype=dtype, device=device)},
            {"scale": (None,)})


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Variance in float32; the scale applied in the input's dtype, as the
    reference casts (``layers.py:54-57``)."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * p["scale"].to(x.dtype)


def embed_init(gen, vocab: int, dim: int, dtype, device=None):
    return ({"embedding": normal(gen, (vocab, dim), 0.02, dtype, device)},
            {"embedding": ("vocab", "fsdp")})


def embed(p: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    # gather, then cast: the same values as the reference's cast-then-gather
    return F.embedding(tokens, p["embedding"]).to(dtype)


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["embedding"].to(x.dtype).T


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    # theta enters as a Python scalar: a tensor made from it on the card
    # would be a host-to-device copy, which waits for the queued work
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Split halves;
    cos and sin in float32, cast to x's dtype (``layers.py:83-95``)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)        # (hd/2,)
    angles = positions[..., :, None].float() * freqs              # (..., s, hd/2)
    cos = torch.cos(angles)[..., :, None, :].to(x.dtype)
    sin = torch.sin(angles)[..., :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_init(gen, d_model: int, d_ff: int, kind: str, dtype, device=None):
    if kind == "swiglu":
        wi, ai = dense_init(gen, d_model, d_ff, None, "ffn", dtype,
                            device=device)
        wg, ag = dense_init(gen, d_model, d_ff, None, "ffn", dtype,
                            device=device)
        wo, ao = dense_init(gen, d_ff, d_model, "ffn", None, dtype,
                            device=device)
        return ({"wi": wi, "wg": wg, "wo": wo},
                {"wi": ai, "wg": ag, "wo": ao})
    wi, ai = dense_init(gen, d_model, d_ff, None, "ffn", dtype, device=device)
    wo, ao = dense_init(gen, d_ff, d_model, "ffn", None, dtype, device=device)
    return {"wi": wi, "wo": wo}, {"wi": ai, "wo": ao}


def mlp(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(dense(p["wg"], x)) * dense(p["wi"], x)
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(dense(p["wi"], x), approximate="tanh")
    return dense(p["wo"], h)
