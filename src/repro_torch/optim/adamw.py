"""AdamW with configurable moment dtype and a cosine learning-rate
schedule, the reference's ``optim/adamw.py`` on PyTorch.

The update runs under ``torch.no_grad()`` in place: each parameter and
its two moments are overwritten.  Its arithmetic is float32 whatever the
storage (bfloat16 parameters, bfloat16 moments for the largest configs),
then cast back to the parameter's dtype and to ``moment_dtype``, as the
reference's.  The step count, the learning rate and the gradient norm are
0-d tensors on the parameters' device, so an update never waits for the
host.

Weight decay applies to a leaf of rank 2 or more *in the reference's
tree*.  The reference stacks a segment's layers along a leading axis, so
there every per-layer leaf (norm scales, biases, Mamba2's ``A_log``,
``D`` and ``dt_bias``, RWKV6's ``w0`` and ``u``) has rank 2 and is
decayed, and only the unstacked vectors (``final_norm``, ``shared_block``,
``mtp``) escape.  The port holds one tensor a layer, so the caller gives
each leaf's reference rank (``ref_ndim``, from
:func:`repro_torch.models.convert.reference_ndim`); without it a leaf's
own rank decides.

Parameters, gradients and moments held as DTensors of one placement (the
launchers' production mesh) are updated on each rank's local blocks: the
update is elementwise, so no block leaves its rank.  The global norm sums
every leaf once over all ranks (DTensor's reduction), not once a rank.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..sharding import full, is_dtensor
from .tree import leaves, tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    moment_dtype: str = "float32"


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (a float32 tensor or a number):
    linear warm-up, then a cosine to zero at ``total_steps``."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * t))


def adamw_init(params: Any, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero moments of ``moment_dtype`` beside each parameter (a DTensor
    parameter's on its placements, local blocks only) and a step count of
    0 (int32, on the first parameter's device)."""
    dt = _DTYPES[cfg.moment_dtype]
    first = leaves(params)[0][1]

    def zeros(p):
        return torch.zeros_like(p, dtype=dt)

    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(tree: Any) -> torch.Tensor:
    """√(Σ over leaves of Σ x²), each leaf's sum in float32, the leaves'
    sums added one after another in the reference's order."""
    total = None
    for _, x in leaves(tree):
        s = torch.sum(torch.square(x.float()))
        s = full(s)  # a DTensor's sum: over all ranks
        total = s if total is None else total + s
    return torch.sqrt(total)


_SLICE = 1 << 26      # elements of one slice of a large leaf


def _row_slices(p: torch.Tensor):
    """Slices of ``p``'s leading axis of at most ``_SLICE`` elements each
    (the whole tensor for a scalar or a small leaf)."""
    if p.dim() == 0 or p.numel() <= _SLICE:
        return [slice(None)]
    rows = max(1, _SLICE // max(1, p[0].numel()))
    return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]


def _update(p, g, mu, nu, scale, lr, c1, c2, cfg: AdamWConfig, mdt,
            decay: bool) -> None:
    """The reference's per-leaf update on one slice, written in place."""
    g = g.float() * scale
    mu32 = mu.float() * cfg.b1 + g * (1 - cfg.b1)
    nu32 = nu.float() * cfg.b2 + torch.square(g) * (1 - cfg.b2)
    del g
    delta = (mu32 / c1) / (torch.sqrt(nu32 / c2) + cfg.eps)
    if decay:
        delta = delta + cfg.weight_decay * p.float()
    p.copy_((p.float() - lr * delta).to(p.dtype))
    mu.copy_(mu32.to(mdt))
    nu.copy_(nu32.to(mdt))


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: Dict[str, Any],
                 cfg: AdamWConfig,
                 ref_ndim: Optional[Dict[str, int]] = None
                 ) -> Tuple[Any, Dict[str, Any], dict]:
    """One AdamW step with the gradients clipped to ``clip_norm`` by their
    global norm.  ``params``, ``state["mu"]`` and ``state["nu"]`` are
    updated in place and returned; ``ref_ndim`` maps a leaf's path to the
    rank of its reference leaf.  Returns (params, state, {"grad_norm",
    "lr"})."""
    step = full(state["step"]) + 1
    step_f = step.float()
    lr = cosine_schedule(cfg, step_f)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    mdt = _DTYPES[cfg.moment_dtype]
    c1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                    device=step.device), step_f)
    c2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                    device=step.device), step_f)
    g_of = dict(leaves(grads))
    mu_of, nu_of = dict(leaves(state["mu"])), dict(leaves(state["nu"]))
    for path, p in leaves(params):
        rank = p.dim() if ref_ndim is None else ref_ndim[path]
        decay = bool(cfg.weight_decay) and rank >= 2   # matrices only
        g, mu, nu = g_of[path], mu_of[path], nu_of[path]
        if is_dtensor(p):
            # DTensors: this rank's blocks, all of one placement
            p, g, mu, nu = (t.to_local() for t in (p, g, mu, nu))
        # a large leaf in slices of its rows, so that the float32
        # temporaries stay small beside the optimizer's state
        for sl in _row_slices(p):
            _update(p[sl], g[sl], mu[sl], nu[sl], scale, lr, c1, c2, cfg,
                    mdt, decay)
    if is_dtensor(state["step"]):       # a replicated DTensor counter
        from torch.distributed.tensor import DTensor
        s0 = state["step"]
        step = DTensor.from_local(step, s0.device_mesh, s0.placements,
                                  run_check=False)
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
