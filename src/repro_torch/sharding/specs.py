"""Spec and placement trees from logical-axes trees, the reference's
``sharding/specs.py``, and the state placed by them as DTensors.

The reference stacks each segment's layers in one leaf; the port holds
one tensor a layer (a :class:`~repro_torch.models.stack.Stack`'s
parameters, and the optimizer's per-parameter moments keyed by the
parameter's name).  Each such tensor takes its reference leaf's axes
without the stacked layer axis (:func:`param_axes`, through
:func:`~repro_torch.models.convert.leaf_map`).
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Any, Dict

import torch
import torch.nn as nn

from .axis_rules import AxisRules, divisible_spec, mesh_sizes, placements


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _is_spec_leaf(x) -> bool:
    """A spec: a tuple of None, axis names and tuples of axis names."""
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str) or (
            isinstance(a, tuple) and all(isinstance(b, str) for b in a))
        for a in x)


def flat_leaves(tree, prefix="", leaf=_is_spec_leaf) -> Dict[str, tuple]:
    """An axes or spec tree → its leaves by dotted path."""
    if leaf(tree):
        return {prefix[:-1]: tree}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree))
    out = {}
    for k, v in items:
        out.update(flat_leaves(v, f"{prefix}{k}.", leaf))
    return out


def param_axes(cfg, axes_tree, names) -> Dict[str, tuple]:
    """Each of the port's parameter ``names`` → its logical axes: those of
    its reference leaf in ``axes_tree`` (the reference's params axes
    tree), without the leading layer axis of a stacked leaf."""
    from ..models.convert import leaf_map
    flat = flat_leaves(axes_tree, leaf=_is_axes_leaf)
    out = {}
    for name, (ref, layer) in leaf_map(cfg, names).items():
        a = flat[ref]
        out[name] = a[1:] if layer >= 0 else a
    return out


def spec_tree(axes_tree: Any, rules: AxisRules) -> Any:
    """axes tree (tuples of logical names) → spec tree."""
    if _is_axes_leaf(axes_tree):
        return rules.spec(axes_tree)
    if isinstance(axes_tree, dict):
        return {k: spec_tree(v, rules) for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(spec_tree(v, rules) for v in axes_tree)
    raise TypeError(f"bad axes node {axes_tree!r}")


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else ()


def divisible_spec_tree(state: Any, axes_tree: Any, rules: AxisRules,
                        sizes: Dict[str, int], cfg=None) -> Any:
    """Matched (state, axes) trees → the spec of each tensor after
    :func:`divisible_spec` on its concrete shape over a mesh of ``sizes``
    ({axis: size}).  A model node (a module with a ``cfg``) gives {its
    parameter name: spec}; a dict of per-parameter tensors (the
    optimizer's moments) matched with a params axes tree maps through
    ``cfg`` (taken from the state's model when not given)."""
    if cfg is None and isinstance(state, dict) and isinstance(
            state.get("params"), nn.Module):
        cfg = state["params"].cfg

    def leaf(x, a):
        return divisible_spec(rules.spec(a), _shape(x), sizes)

    def go(x, a):
        if _is_axes_leaf(a):
            return leaf(x, a)
        if isinstance(x, nn.Module):
            named = dict(x.named_parameters())
            ax = param_axes(x.cfg, a, named)
            return {n: leaf(p, ax[n]) for n, p in named.items()}
        if isinstance(x, dict) and isinstance(a, dict):
            if set(x) <= set(a):
                return {k: go(x[k], a[k]) for k in x}
            if cfg is None:
                raise ValueError("a per-parameter dict needs the config")
            ax = param_axes(cfg, a, x)
            return {n: leaf(t, ax[n]) for n, t in x.items()}
        if isinstance(x, (list, tuple)) and isinstance(a, (list, tuple)):
            return [go(xx, aa) for xx, aa in zip(x, a)]
        raise TypeError(f"bad axes node {a!r} for {type(x).__name__}")

    return go(state, axes_tree)


def sharding_tree(state: Any, axes_tree: Any, rules: AxisRules, mesh,
                  cfg=None) -> Any:
    """Matched (state, axes) trees → the tree of DTensor placement lists
    over the named ``DeviceMesh`` ``mesh``, with the divisibility fallback
    applied to each tensor's concrete shape."""
    return _placements_tree(divisible_spec_tree(
        state, axes_tree, rules, mesh_sizes(mesh), cfg), mesh)


def _placements_tree(specs: Any, mesh) -> Any:
    if _is_spec_leaf(specs):
        return placements(specs, mesh)
    if isinstance(specs, dict):
        return {k: _placements_tree(v, mesh) for k, v in specs.items()}
    return [_placements_tree(v, mesh) for v in specs]


def local_block(x: torch.Tensor, mesh, place) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``place`` (a
    view of ``x``)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        x.shape, mesh, place)
    for d, (n, o) in enumerate(zip(shape, offset)):
        if n != x.shape[d]:
            x = x.narrow(d, o, n)
    return x


def reshape(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.reshape(*shape)``.  A DTensor sharded on a dimension that the
    reshape splits or merges unevenly for its mesh (40 heads over a model
    axis of 16) is first made whole on that dimension, and so is its
    gradient on the way back; a dimension that the reshape leaves alone
    keeps its shard."""
    if not _split(x):
        return x.reshape(*shape)
    return _Reshape.apply(x, tuple(shape))


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = tuple(x.shape)
        return _reshape_dtensor(x, shape)

    @staticmethod
    def backward(ctx, grad):
        return _reshape_dtensor(grad, ctx.shape), None


def _reshape_dtensor(x, shape):
    from torch.distributed.tensor import Replicate, Shard
    old = tuple(x.shape)
    new = list(shape)
    if -1 in new:
        known = 1
        for n in new:
            known *= n if n != -1 else 1
        new[new.index(-1)] = x.numel() // known
    pre = 0
    while pre < min(len(old), len(new)) and old[pre] == new[pre]:
        pre += 1
    suf = 0
    while (suf < min(len(old), len(new)) - pre
           and old[-1 - suf] == new[-1 - suf]):
        suf += 1
    sizes = x.device_mesh.mesh.shape
    count: Dict[int, int] = {}
    for m, pl in enumerate(x.placements):
        if isinstance(pl, Shard):
            count[pl.dim] = count.get(pl.dim, 1) * sizes[m]
    bad = set()
    for d, n in count.items():
        if d < pre or d >= len(old) - suf:
            continue                      # a dimension the view keeps
        if d == pre and old[d] % n == 0 and new[pre] % n == 0:
            continue                      # the outer factor keeps the shard
        bad.add(d)
    if bad:
        want = [Replicate() if isinstance(pl, Shard) and pl.dim in bad
                else pl for pl in x.placements]
        x = x.redistribute(x.device_mesh, want)
    return x.reshape(*new)


def _keep(x, dims):
    """A DTensor ``x`` with its splits of ``dims`` kept and every other
    dimension made whole (a partial sum reduced)."""
    from torch.distributed.tensor import Replicate, Shard
    want = [p if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in x.placements]
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def _fold_dims(x):
    return (0, x.ndim - 1)


class _Keep(torch.autograd.Function):
    """``_keep`` on the way forward and on the gradient's way back."""

    @staticmethod
    def forward(ctx, x, dims_of):
        ctx.dims_of = dims_of
        return _keep(x, dims_of(x))

    @staticmethod
    def backward(ctx, grad):
        # contiguous: a view of the gradient further back needs it
        return _keep(grad, ctx.dims_of(grad)).contiguous(), None


class _KeepGrad(torch.autograd.Function):
    """The identity on the way forward, ``_keep`` on the gradient."""

    @staticmethod
    def forward(ctx, x, dims_of):
        ctx.dims_of = dims_of
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _keep(grad, ctx.dims_of(grad)).contiguous(), None


class ShareGrad(torch.autograd.Function):
    """The identity on the way forward; on the way back the gradient
    divided by ``n``: one of the equal shares of the ``n`` ranks that
    computed the same block on their local tensors."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n if ctx.n > 1 else grad, None


def shares(place) -> list:
    """A local block's gradient placements: split where ``place`` splits,
    elsewhere one rank's share of a sum (``Partial``).  With
    :class:`ShareGrad` on what the local computation returns, a rank's
    gradient of a block it holds whole is its share, and the shares sum
    to the gradient once."""
    from torch.distributed.tensor import Partial, Replicate
    return [Partial() if isinstance(q, Replicate) else q for q in place]


def block_spec(x: torch.Tensor, axes) -> tuple:
    """The current rules' spec of ``x``'s logical ``axes`` over its mesh,
    after :func:`divisible_spec`; every dim whole for a plain tensor."""
    from .axis_rules import current_rules, is_dtensor
    if not is_dtensor(x):
        return (None,) * x.ndim
    return divisible_spec(current_rules().spec(tuple(axes)), tuple(x.shape),
                          mesh_sizes(x.device_mesh))


def block_offset(x: torch.Tensor, spec: tuple, dim: int) -> int:
    """Where this rank's block of ``x`` under ``spec`` starts along
    ``dim``; 0 for a plain tensor."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from .axis_rules import is_dtensor
    if not is_dtensor(x):
        return 0
    mesh = x.device_mesh
    _, offset = compute_local_shape_and_global_offset(
        x.shape, mesh, placements(spec, mesh))
    return int(offset[dim])


def on_blocks(fn, args, specs, out_specs):
    """``fn(*args)`` on this rank's local blocks: the reference's
    ``shard_map`` at the point where its constraints split an operation
    (attention over the batch and the heads, a recurrence over the batch
    and its heads, the MoE layer).  ``specs[i]`` is the spec that
    ``args[i]`` is brought to (:func:`block_spec`); ``fn`` gets each
    DTensor operand's local block, and a plain operand's block (a zero
    state, the same on every rank).  Each tensor ``fn`` returns comes back
    as a DTensor of the placements of its ``out_specs`` entry.  Gradients
    are each rank's shares: an input block's gradient is summed over the
    mesh dims the block is whole on (:func:`shares`), and the ranks that
    return the same output block each take an equal share of its
    gradient (:class:`ShareGrad`).  With no DTensor operand, ``fn`` on
    the arguments as they are."""
    from torch.distributed.tensor import DTensor, Replicate

    from .axis_rules import is_dtensor
    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)

    def local(a, spec):
        if not isinstance(a, torch.Tensor):
            return a
        pl = placements(spec, mesh)
        if not is_dtensor(a):
            return local_block(a, mesh, pl)
        if list(a.placements) != pl:
            a = a.redistribute(mesh, pl)
        return a.to_local(grad_placements=shares(pl))

    def back(t, spec):
        pl = placements(spec, mesh)
        same = math.prod(n for n, q in zip(mesh.mesh.shape, pl)
                         if isinstance(q, Replicate))
        return DTensor.from_local(ShareGrad.apply(t, same), mesh, pl,
                                  run_check=False)

    out = fn(*[local(a, s) for a, s in zip(args, specs)])
    if isinstance(out, tuple):
        return tuple(back(t, s) for t, s in zip(out, out_specs))
    return back(out, out_specs)


def _split(x) -> bool:
    """Whether ``x`` is a DTensor over more than one rank (on a mesh of
    one rank every block is whole, and every view is allowed)."""
    from .axis_rules import is_dtensor
    return is_dtensor(x) and x.device_mesh.size() > 1


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``.  The product folds ``x``'s leading dims into one, which
    a DTensor allows (torch 2.11) only with no inner dim split, so a
    DTensor ``x`` of more than two dims keeps its split of the first and
    the last dim only, and so does the gradient of the product."""
    if not _split(x) or x.ndim <= 2:
        return x @ w
    y = _Keep.apply(x, _fold_dims) @ w
    return _KeepGrad.apply(y, _fold_dims)


def write_at(dst: torch.Tensor, dim: int, index: int,
             new: torch.Tensor) -> None:
    """``dst``'s positions ``index`` to ``index + n`` along ``dim`` set to
    ``new`` (of length ``n`` there) in place.  For a DTensor ``dst`` the
    write is local: ``new`` is brought to ``dst``'s placements with
    ``dim`` whole, and each rank writes the part its block holds."""
    from .axis_rules import is_dtensor
    n_new = new.shape[dim]
    if not is_dtensor(dst):
        dst.narrow(dim, index, n_new).copy_(new)
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = dst.device_mesh
    want = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in dst.placements]
    if not is_dtensor(new):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    new_local = new.redistribute(mesh, want).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        dst.shape, mesh, dst.placements)
    a = max(offset[dim], index)
    b = min(offset[dim] + shape[dim], index + n_new)
    if a < b:
        dst.to_local().narrow(dim, a - offset[dim], b - a).copy_(
            new_local.narrow(dim, a - index, b - a))


def store_layer(dst: torch.Tensor, i: int, new: torch.Tensor) -> None:
    """``dst[i] = new`` on the leading (layer) axis, in place, unless
    ``new`` already is that layer's storage; local for a DTensor (whose
    layer axis is never split)."""
    from torch.distributed.tensor import Shard

    from .axis_rules import is_dtensor
    if not is_dtensor(dst):
        view = dst[i]
        if new.data_ptr() != view.data_ptr():
            view.copy_(new)
        return
    local = dst.to_local()[i]
    # a layer's placements: each split one dim lower
    want = [Shard(p.dim - 1) if isinstance(p, Shard) else p
            for p in dst.placements]
    if is_dtensor(new):
        if new.to_local().data_ptr() == local.data_ptr():
            return
        new_local = new.redistribute(dst.device_mesh, want).to_local()
    else:
        new_local = local_block(new, dst.device_mesh, want)
    local.copy_(new_local)


def to_dtensor(x: torch.Tensor, mesh, place, copy: bool = True):
    """The global tensor ``x`` (the same on every rank) as a DTensor of
    placements ``place``: this rank's block, copied unless it is the whole
    tensor or ``copy`` is False."""
    from torch.distributed.tensor import DTensor
    local = local_block(x, mesh, place)
    if copy and local.shape != x.shape:
        local = local.clone()
    return DTensor.from_local(local, mesh, place, run_check=False,
                              shape=x.shape, stride=x.stride())


def distribute_tree(state: Any, place_tree: Any, mesh) -> Any:
    """Place ``state`` (matched with ``place_tree``, from
    :func:`sharding_tree`) as DTensors: a model's parameters are replaced
    in place by parameters holding DTensors; every other tensor leaf is
    returned as a DTensor.  Leaves that are not tensors, and DTensors
    (placed as they were drawn, :func:`drawn_in_place`), stay."""
    from .axis_rules import is_dtensor

    def go(x, p):
        if isinstance(x, nn.Module):
            with torch.no_grad():
                for name, param in list(x.named_parameters()):
                    if is_dtensor(param):
                        continue
                    mod_name, _, leaf = name.rpartition(".")
                    mod = x.get_submodule(mod_name) if mod_name else x
                    mod._parameters[leaf] = nn.Parameter(
                        to_dtensor(param.detach(), mesh, p[name]),
                        requires_grad=param.requires_grad)
            return x
        if isinstance(x, dict):
            return {k: go(v, p[k]) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(go(v, pp) for v, pp in zip(x, p))
        if isinstance(x, torch.Tensor) and not is_dtensor(x):
            return to_dtensor(x, mesh, p)
        return x

    return go(state, place_tree)


POD = "pod"


def state_mesh(mesh):
    """The mesh DTensors live on: ``mesh`` without its ``pod`` dimension.

    The rules split nothing but the batch over ``pod`` (the parameters'
    ``fsdp`` axis is ``data``), so each pod holds a whole replica of the
    state on its ``data`` × ``model`` sub-mesh, runs its block of the
    batch, and the train step averages the gradients over ``pod``
    (``models.steps``).  This is the same program as DTensors over all
    three dimensions, and DTensor's sharding propagation over a
    two-dimensional mesh is fast where over three it is not (65 s for the
    first matmul of a 2×2×2 mesh on torch 2.13)."""
    names = tuple(mesh.mesh_dim_names)
    if POD not in names or len(names) == 1:
        return mesh
    return mesh[tuple(n for n in names if n != POD)]


def _pod_block(tree, specs, pod: int, n_pod: int):
    """Each tensor of ``tree`` narrowed to pod ``pod``'s block of the
    dimension its spec splits over ``pod`` (the outer split); the specs
    without ``pod``."""
    def entry_axes(e):
        return () if e is None else ((e,) if isinstance(e, str) else e)

    def go(x, s):
        if _is_spec_leaf(s):
            out = []
            for d, e in enumerate(s):
                axes = entry_axes(e)
                if POD in axes:
                    if axes[0] != POD:
                        raise ValueError(f"{POD!r} must be the outer axis "
                                         f"of {e!r}")
                    n = x.shape[d] // n_pod
                    x = x.narrow(d, pod * n, n)
                    axes = axes[1:]
                out.append(None if not axes else
                           axes[0] if len(axes) == 1 else tuple(axes))
            return x, tuple(out)
        if isinstance(x, nn.Module):
            if any(POD in entry_axes(e) for v in s.values() for e in v):
                raise ValueError(f"a parameter split over {POD!r}")
            return x, s
        if isinstance(x, dict):
            pairs = {k: go(x[k], s[k]) for k in x}
            return ({k: v[0] for k, v in pairs.items()},
                    {k: v[1] for k, v in pairs.items()})
        if isinstance(x, (list, tuple)):
            pairs = [go(xx, ss) for xx, ss in zip(x, s)]
            return type(x)(p[0] for p in pairs), [p[1] for p in pairs]
        return x, s

    return go(tree, specs)


def place(tree: Any, axes_tree: Any, rules: AxisRules, mesh,
          cfg=None) -> Any:
    """``tree`` placed as DTensors by ``rules`` over the named
    ``DeviceMesh`` ``mesh`` (:func:`sharding_tree`, then
    :func:`distribute_tree`).  Over a mesh with a ``pod`` dimension, each
    tensor split over ``pod`` keeps this pod's block, and the DTensors
    live on :func:`state_mesh`."""
    specs = divisible_spec_tree(tree, axes_tree, rules, mesh_sizes(mesh),
                                cfg)
    sub = state_mesh(mesh)
    if sub is not mesh:
        names = list(mesh.mesh_dim_names)
        tree, specs = _pod_block(tree, specs, mesh.get_local_rank(POD),
                                 mesh.mesh.shape[names.index(POD)])
    return distribute_tree(tree, _placements_tree(specs, sub), sub)


@contextmanager
def drawn_in_place(cfg, rules: AxisRules, mesh):
    """Inside it, ``init_params(cfg, seed, device)`` keeps of each
    parameter it draws only this rank's block, placed by ``rules`` over
    ``mesh`` as :func:`place` places it, as soon as the parameter is
    registered on its module: a rank never holds more of the whole model
    than the block being drawn (its generator's draws are the same, so
    the values are too).  A meta build of ``cfg`` gives each parameter's
    name and placements in the order the build registers them."""
    from torch.nn.modules.module import \
        register_module_parameter_registration_hook as on_register

    from ..models.stack import init_params
    from .axis_rules import is_dtensor
    order = []
    hook = on_register(lambda module, name, param: order.append(param))
    try:
        meta, axes = init_params(cfg, 0, "meta")
    finally:
        hook.remove()
    names = {id(p): n for n, p in meta.named_parameters()}
    specs = divisible_spec_tree(meta, axes, rules, mesh_sizes(mesh))
    sub = state_mesh(mesh)
    if sub is not mesh:     # checks that no parameter is split over pod
        _pod_block(meta, specs, 0, 1)
    where = _placements_tree(specs, sub)
    queue = iter([where[names[id(p)]] for p in order])

    def keep(module, name, param):
        if is_dtensor(param):
            return None
        return nn.Parameter(to_dtensor(param.detach(), sub, next(queue)),
                            requires_grad=param.requires_grad)
    hook = on_register(keep)
    try:
        yield
    finally:
        hook.remove()


def local_bytes(tree: Any) -> int:
    """Bytes of this rank's blocks of every tensor in ``tree`` (a model's
    parameters included); a DTensor counts its local block."""
    from torch.distributed.tensor import DTensor
    total = 0

    def go(x):
        nonlocal total
        if isinstance(x, nn.Module):
            for p in x.parameters():
                go(p)
        elif isinstance(x, dict):
            for v in x.values():
                go(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                go(v)
        elif isinstance(x, torch.Tensor):
            t = x.to_local() if isinstance(x, DTensor) else x
            total += t.numel() * t.element_size()

    go(tree)
    return total
