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

Under a :class:`~repro_torch.launch.mesh.ModelMesh` with a ``model`` axis
(:func:`~repro_torch.launch.mesh.use_model_mesh`, which both launchers
enter with the mesh of one rank, as the reference's enter
``make_host_mesh()``) ``moe_apply`` takes the reference's expert-parallel
paths instead, on ``torch.distributed``: at most 512 tokens over the
mesh, SwiGLU and a ``data`` axis that divides ``d_model``, the
weights-stationary pass (``_moe_decode_stationary``: every token reaches
every chosen expert, with no capacity); otherwise the sharded pass
(``_moe_sharded`` over ``_local_expert_pass``: capacity from the rank's
own token count, kept choices in their slots, the rest in a trash slot).
Each rank holds its block of the batch over the batch axes, the same on
every rank of a ``model`` line, and returns the same block of ``y``;
expert weights are read whole (each rank slices its experts, and in the
stationary pass its ``d_model`` slice).  On one rank every collective is
the identity, so what the mesh changes there is the capacity rule.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..launch.mesh import current_model_mesh
from ..sharding import is_dtensor
from ..sharding import with_logical_constraint as wlc
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
    h = wlc(h, ("experts", None, "expert_ffn"))
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
    """x: (B, S, d) → (y, aux_loss): on a mesh with a ``model`` axis the
    expert-parallel paths, else ``_moe_global`` (the reference's
    dispatch, ``moe.py:64-86``).  A DTensor ``x`` (state placed over a
    ``DeviceMesh``) takes the mesh paths on its local blocks
    (:func:`_moe_dtensor`)."""
    mesh = current_model_mesh()
    if is_dtensor(x):
        return _moe_dtensor(p, cfg, x, mesh)
    if mesh is not None and "model" in mesh.axis_names:
        return _moe_sharded(p, cfg, x, mesh)
    return _moe_global(p, cfg, x)


def _moe_global(p: Params, cfg: ModelConfig, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The off-mesh path over all ``B·S`` tokens."""
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
    expert_in = wlc(expert_in, ("experts", "fsdp", None))
    expert_out = _expert_ffn(p, expert_in, cfg.mlp)
    expert_out = wlc(expert_out, ("experts", "fsdp", None))
    expert_out = expert_out.reshape(E * cap, d)

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


def _aux_loss(cfg: ModelConfig, probs, choices) -> torch.Tensor:
    """The load-balancing loss from the choices' one-hot counts."""
    m = cfg.moe
    E = m.num_experts
    counts = F.one_hot(choices, E).float().sum(dim=(0, 1))
    frac_tokens = counts / float(choices.shape[0] * m.top_k)
    frac_probs = probs.mean(dim=0)
    return E * torch.sum(frac_tokens * frac_probs) * m.router_aux_weight


# ---------------------------------------------------------------------------
# the expert-parallel paths (the reference's shard_map bodies, SPMD)
# ---------------------------------------------------------------------------

# At most this many tokens over the mesh (decode, small serving batches),
# the weights stay where they are and the tokens are replicated: the
# reference's _TOKEN_STATIONARY_MAX.
TOKEN_STATIONARY_MAX = 512


def _experts(p: Params, name: str, e_lo: int, E_local: int,
             d_axis: int = -1, d_lo: int = 0, d_sh: int = 0):
    """This rank's block of the stacked expert weight ``name``: experts
    ``[e_lo, e_lo + E_local)`` and, given ``d_sh``, ``d_model`` rows or
    columns ``[d_lo, d_lo + d_sh)`` on axis ``d_axis``.  A weight that
    already holds only the block (its leading axis ``E_local``) is taken
    as it is."""
    w = p[name]
    if w.shape[0] != E_local:
        w = w[e_lo:e_lo + E_local]
    if d_sh and w.shape[d_axis] != d_sh:
        w = w.narrow(d_axis, d_lo, d_sh)
    return w


def _batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _batch_index(mesh, axes) -> int:
    """This rank's block of the batch over ``axes`` (row-major)."""
    idx = 0
    for a in axes:
        idx = idx * mesh.axis_size(a) + mesh.axis_index(a)
    return idx


def _gather_batch(mesh, x, axes):
    """The batch blocks of every rank over ``axes``, in order."""
    for a in reversed(axes):
        x = mesh.all_gather(x, a, dim=0)
    return x


def moe_path(cfg: ModelConfig, B: int, S: int, mesh=None, batch_axes=None):
    """Which path ``moe_apply`` takes for a rank's block of ``B`` × ``S``
    tokens under ``mesh`` (None: off the mesh), the batch split over
    ``batch_axes`` (by default every batch axis of the mesh), and the
    capacity it gives an expert: ``("global", cap)`` over all tokens,
    ``("sharded", cap)`` from the rank's own tokens, or ``("stationary",
    None)``, which drops nothing."""
    if mesh is None or "model" not in mesh.axis_names:
        return "global", capacity(cfg, B * S)
    if batch_axes is None:
        batch_axes = _batch_axes(mesh)
    n_b = math.prod(mesh.axis_size(a) for a in batch_axes)
    if cfg.moe.num_experts % mesh.axis_size("model"):
        return "global", capacity(cfg, B * n_b * S)
    if (B * n_b * S <= TOKEN_STATIONARY_MAX and cfg.mlp == "swiglu"
            and "data" in mesh.axis_names
            and cfg.d_model % mesh.axis_size("data") == 0):
        return "stationary", None
    return "sharded", capacity(cfg, B * S)


def _local_expert_pass(p: Params, cfg: ModelConfig, xf: torch.Tensor,
                       gate_vals: torch.Tensor, choices: torch.Tensor,
                       e_lo: int, E_local: int) -> torch.Tensor:
    """The rank's tokens routed to experts ``[e_lo, e_lo + E_local)``:
    dispatch, the local expert FFNs, the gated combine.  Capacity from the
    rank's own token count; kept choices only are written to their slots,
    the rest (other ranks' experts, overflow) to a trash slot.  The caller
    sums over the ``model`` axis."""
    m = cfg.moe
    T, d = xf.shape
    k = m.top_k
    dev = xf.device
    cap = capacity(cfg, T)

    flat_e = choices.reshape(T * k) - e_lo                  # local ids
    local = (flat_e >= 0) & (flat_e < E_local)
    flat_e = torch.where(local, flat_e, E_local)            # overflow bin
    flat_tok = torch.arange(T * k, device=dev) // k
    sorted_e, order = torch.sort(flat_e, stable=True)
    counts = torch.zeros(E_local + 1, dtype=torch.long,
                         device=dev).scatter_add_(0, flat_e,
                                                  torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(T * k, device=dev) - starts[sorted_e]
    keep_sorted = (pos_sorted < cap) & (sorted_e < E_local)
    slot_sorted = torch.where(keep_sorted, sorted_e * cap + pos_sorted,
                              E_local * cap)                # trash slot
    slot_tok = torch.full((E_local * cap + 1,), T, dtype=torch.long,
                          device=dev)
    slot_tok[slot_sorted] = torch.where(keep_sorted, flat_tok[order], T)
    slot_tok = slot_tok[:E_local * cap]

    x_pad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    expert_in = x_pad[slot_tok].reshape(E_local, cap, d)
    local_p = {n: _experts(p, n, e_lo, E_local)
               for n in ("wi", "wg", "wo") if n in p}
    expert_out = _expert_ffn(local_p, expert_in, cfg.mlp).reshape(
        E_local * cap, d)
    expert_out = torch.cat([expert_out, expert_out.new_zeros((1, d))],
                           dim=0)

    # combine: inverse permutation → slot per (token, choice)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=dev)
    pos = pos_sorted[inv]
    kept = (pos < cap) & local
    slot = torch.where(kept, flat_e * cap + pos, E_local * cap)
    slot2, kept2 = slot.reshape(T, k), kept.reshape(T, k)
    y = torch.zeros_like(xf)
    for i in range(k):  # in order, as the reference adds them
        contrib = expert_out[slot2[:, i]]
        w = (gate_vals[:, i] * kept2[:, i]).to(xf.dtype)
        y = y + contrib * w[:, None]
    return y


def _moe_sharded(p: Params, cfg: ModelConfig, x: torch.Tensor, mesh,
                 axes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel pass (the reference's ``_moe_sharded``), or the
    stationary pass where the dispatch rule takes it.  ``x`` is this
    rank's block of the batch, split over ``axes`` (by default every
    batch axis of the mesh)."""
    m = cfg.moe
    B, S, d = x.shape
    axes = _batch_axes(mesh) if axes is None else tuple(axes)
    path, _ = moe_path(cfg, B, S, mesh, axes)
    if path == "global":
        # experts that the model axis does not divide: the global path
        # over every rank's tokens, then this rank's block
        y, aux = _moe_global(p, cfg, _gather_batch(mesh, x, axes))
        b0 = _batch_index(mesh, axes) * B
        return y[b0:b0 + B], aux
    if path == "stationary":
        return _moe_decode_stationary(p, cfg, x, mesh, axes)
    E_local = m.num_experts // mesh.axis_size("model")
    xf = x.reshape(B * S, d)
    probs, gate_vals, choices = route(p, cfg, xf)
    e_lo = mesh.axis_index("model") * E_local
    y = _local_expert_pass(p, cfg, xf, gate_vals, choices, e_lo, E_local)
    # the experts of the other model ranks
    y = mesh.psum(y, "model")
    if m.num_shared_experts:
        y = y + mlp(p["shared"], xf, cfg.mlp)
    aux = _aux_loss(cfg, probs, choices)
    if axes:
        aux = mesh.pmean(aux, axes)
    return y.reshape(B, S, d), aux


def _moe_decode_stationary(p: Params, cfg: ModelConfig, x: torch.Tensor,
                           mesh, axes=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weights-stationary pass (the reference's
    ``_moe_decode_stationary``): the tokens of every batch block gathered
    on each rank; rank ``(data i, model j)`` holds experts ``j·E_l`` to
    ``(j+1)·E_l`` with ``wi``/``wg`` rows and ``wo`` columns of its
    ``d_model`` slice ``i``; it contracts its slice for every token, the
    partial hiddens are summed over ``data`` before the SiLU, the gated
    outputs over ``model``, and the slices gathered over ``data``.  No
    capacity: every token-choice reaches its expert."""
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    B, S, d = x.shape
    model_size, data_size = mesh.axis_size("model"), mesh.axis_size("data")
    E_local = E // model_size
    axes = _batch_axes(mesh) if axes is None else tuple(axes)
    x_full = _gather_batch(mesh, x, axes)                   # replicated
    Bf = x_full.shape[0]
    T = Bf * S
    xf = x_full.reshape(T, d)
    probs, gate_vals, choices = route(p, cfg, xf)

    e_lo = mesh.axis_index("model") * E_local
    d_sh = d // data_size
    d_lo = mesh.axis_index("data") * d_sh
    # dense per-expert token weights (T small): (E_local, T), the k
    # choices added in order
    experts = torch.arange(E_local, device=x.device)
    w_et = torch.zeros((E_local, T), dtype=torch.float32, device=x.device)
    for i in range(k):
        onehot = ((choices[:, i] - e_lo)[:, None] == experts).float()
        w_et = w_et + onehot.T * gate_vals[:, i][None, :]
    wg = _experts(p, "wg", e_lo, E_local, 1, d_lo, d_sh)
    wi = _experts(p, "wi", e_lo, E_local, 1, d_lo, d_sh)
    wo = _experts(p, "wo", e_lo, E_local, 2, d_lo, d_sh)
    x_slice = xf[:, d_lo:d_lo + d_sh]
    # partial hiddens for every (expert, token) over the local d-slice,
    # completed over data before the SiLU: batched products over the
    # experts (the reference's einsum "td,edf->etf"), which read each
    # expert's weights in place
    xe = x_slice.to(wg.dtype).expand(E_local, T, d_sh)
    hg = mesh.psum(torch.bmm(xe, wg), "data")
    hi = mesh.psum(torch.bmm(xe.to(wi.dtype), wi), "data")
    h = F.silu(hg) * hi
    # "etf,efd,et->td": one product contracting experts and d_ff
    # together, wo read in place as (E_local·d_ff, d_sh)
    hw = (h * w_et.to(h.dtype)[:, :, None]).transpose(0, 1)
    y_slice = hw.reshape(T, -1) @ wo.reshape(-1, wo.shape[-1])
    y_slice = mesh.psum(y_slice, "model")
    y = mesh.all_gather(y_slice, "data", dim=1)             # (T, d)
    if m.num_shared_experts:
        y = y + mlp(p["shared"], xf, cfg.mlp)
    aux = _aux_loss(cfg, probs, choices)
    # this rank's block of the batch
    b0 = _batch_index(mesh, axes) * B
    return y.reshape(Bf, S, d)[b0:b0 + B], aux


def _moe_dtensor(p: Params, cfg: ModelConfig, x, mesh
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_apply`` on a DTensor ``x`` with DTensor weights: the mesh
    paths run on this rank's local blocks (``on_blocks``; the reference
    runs them under ``shard_map``).  ``x`` is brought to the rules' batch
    split (whole on the ``model`` axis); each weight to the block its path
    reads: the router and the shared experts whole, the experts of this
    ``model`` rank (in the stationary pass with the ``data`` rank's
    ``d_model`` slice), or every expert where ``model`` does not divide
    them.  ``y`` comes back as a DTensor of ``x``'s batch split, ``aux``
    replicated."""
    from ..launch.mesh import model_mesh_from
    from ..sharding.specs import block_spec, on_blocks
    dm = x.device_mesh
    if mesh is None or mesh.device_mesh is not dm:
        mesh = model_mesh_from(dm)
    sx = block_spec(x, ("batch", None, None))
    b_axes = () if sx[0] is None else (
        (sx[0],) if isinstance(sx[0], str) else tuple(sx[0]))
    sizes = dict(zip(dm.mesh_dim_names, dm.mesh.shape))
    n_b = math.prod(sizes[a] for a in b_axes)
    path, _ = moe_path(cfg, x.shape[0] // n_b, x.shape[1], mesh, b_axes)
    # (key path, tensor, spec) of each weight the path reads
    weights = [(("router",), p["router"]["w"], (None, None))]
    if "shared" in p:
        weights += [(("shared", n), p["shared"][n]["w"], (None, None))
                    for n in ("wi", "wg", "wo") if n in p["shared"]]
    for n in ("wi", "wg", "wo"):
        if n in p:
            spec = [None, None, None]
            if path != "global":
                spec[0] = "model"
            if path == "stationary":
                spec[2 if n == "wo" else 1] = "data"
            weights.append(((n,), p[n], tuple(spec)))

    def local(xl, *ws):
        lp = {}
        for (key, _, _), w in zip(weights, ws):
            if key[0] in ("router", "shared"):
                lp.setdefault(key[0], {})
                node = lp[key[0]] if key[0] == "router" else \
                    lp[key[0]].setdefault(key[1], {})
                node["w"] = w
            else:
                lp[key[0]] = w
        return _moe_sharded(lp, cfg, xl, mesh, b_axes)
    return on_blocks(local, (x,) + tuple(w for _, w, _ in weights),
                     (sx,) + tuple(s for _, _, s in weights), (sx, ()))


class MoE(ParamTree):
    """One MoE layer's weights (``router``, stacked ``wi``/``wg``/``wo``,
    optional ``shared``), keyed as the reference's params tree."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, x):
        return moe_apply(self, self.cfg, x)
