"""Logical-axis sharding rules, the reference's ``sharding/axis_rules.py``
on ``torch.distributed.tensor``.

Model code names a tensor's dimensions with *logical* axes
(``("batch", "seq", "d_model")``); a rules table maps each logical name to
mesh axes.  Swapping the table re-shards the whole model: the same stack
trains (FSDP × TP), prefills (DP × TP) and decodes at long context
(SP × TP) with no change to the model code.

A logical name maps to one mesh axis, a tuple of mesh axes (the dimension
is split over their product, the first the outer), or ``None``
(replicated).  A *spec* is the reference's ``PartitionSpec`` as a plain
tuple, one entry per dimension: ``None``, an axis name or a tuple of
names.  :func:`placements` turns a spec into the list of DTensor
placements over a named ``DeviceMesh``: ``Shard(d)`` on every mesh
dimension that splits tensor dimension ``d``.  DTensor splits a dimension
sharded over several mesh dimensions in mesh-dimension order, the outer
mesh dimension first, which gives rank ``r`` of the row-major mesh the
block that JAX gives device ``r`` when the spec names the axes in mesh
order, as every table here does (``("pod", "data")``); a spec naming them
in another order is refused.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]


@dataclass(frozen=True)
class AxisRules:
    rules: Tuple[Tuple[str, MeshAxes], ...]

    @staticmethod
    def of(**kw: MeshAxes) -> "AxisRules":
        return AxisRules(tuple(kw.items()))

    def lookup(self, name: Optional[str]) -> MeshAxes:
        if name is None:
            return None
        for k, v in self.rules:
            if k == name:
                return v
        return None

    def spec(self, logical_axes: Sequence[Optional[str]]) -> Spec:
        seen = []
        out = []
        for name in logical_axes:
            axes = self.lookup(name)
            if axes is None:
                out.append(None)
                continue
            axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
            # a mesh axis may appear at most once in a spec
            axes_t = tuple(a for a in axes_t if a not in seen)
            seen.extend(axes_t)
            if not axes_t:
                out.append(None)
            elif len(axes_t) == 1:
                out.append(axes_t[0])
            else:
                out.append(axes_t)
        return tuple(out)


# Default rules: FSDP over `data`, TP over `model`, DP over `pod`+`data`,
# Megatron-style sequence parallelism: the residual stream (and logits/CE)
# shard `seq` over `model` between blocks; TP regions gather seq internally.
TRAIN_RULES = AxisRules.of(
    batch=("pod", "data"),
    seq="model",
    d_model=None,
    heads="model",
    kv_heads="model",
    head_dim=None,
    ffn="model",
    experts="model",
    expert_ffn=None,
    vocab="model",
    fsdp="data",          # parameter sharding axis (ZeRO-3 style)
    window=None,
    states=None,
    cache_seq=None,
    conv=None,
)

# Decode/prefill: batch over pod+data, heads/experts over model; parameters
# keep the fsdp axis too.  cache_seq shards over `model`: with kv_heads
# smaller than the model axis the cache cannot shard by head.
DECODE_RULES = AxisRules.of(
    batch=("pod", "data"),
    seq=None,
    d_model=None,
    heads="model",
    kv_heads="model",
    head_dim=None,
    ffn="model",
    experts="model",
    expert_ffn=None,
    vocab="model",
    fsdp="data",
    window=None,
    states=None,
    cache_seq="model",
    conv=None,
)

# Long-context decode (batch=1): sequence parallelism — the KV/conv caches
# and attention shard their *sequence* axis over `data`, heads over `model`.
LONG_DECODE_RULES = AxisRules.of(
    batch="pod",
    seq=None,
    d_model=None,
    heads="model",
    kv_heads="model",
    head_dim=None,
    ffn="model",
    experts="model",
    expert_ffn=None,
    vocab="model",
    fsdp="data",
    window=None,
    states=None,
    cache_seq="data",
    conv=None,
)

_local = threading.local()


def current_rules() -> AxisRules:
    return getattr(_local, "rules", TRAIN_RULES)


@contextmanager
def set_rules(rules: AxisRules):
    prev = current_rules()
    _local.rules = rules
    try:
        yield
    finally:
        _local.rules = prev


def logical_spec(logical_axes: Sequence[Optional[str]]) -> Spec:
    return current_rules().spec(logical_axes)


def divisible_spec(spec: Spec, shape: Tuple[int, ...],
                   axis_sizes: Dict[str, int]) -> Spec:
    """Drop mesh axes that are absent from the mesh or do not divide the
    dimension: e.g. kv_heads=8 cannot shard over a model axis of 16, so
    that dimension is replicated instead."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        kept, tot = [], 1
        for a in axes:
            if a not in axis_sizes:   # axis absent from this mesh (e.g. pod)
                continue
            sz = axis_sizes[a]
            if dim % (tot * sz) == 0:
                kept.append(a)
                tot *= sz
        out.append(tuple(kept) if len(kept) > 1 else
                   (kept[0] if kept else None))
    return tuple(out)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a named ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def placements(spec: Spec, mesh) -> list:
    """The DTensor placements of ``spec`` over ``mesh``: for each mesh
    dimension, ``Shard(d)`` when the spec splits tensor dimension ``d``
    over it, else ``Replicate()``.  A mesh dimension of one rank
    replicates: its one block is the whole dimension either way, and a
    replicated one never asks DTensor to redistribute."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    sizes = mesh.mesh.shape
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} names mesh axes out of "
                             f"the mesh's order {tuple(names)}")
        for i in idx:
            if sizes[i] > 1:
                out[i] = Shard(d)
    return out


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicate(x):
    """A DTensor gathered whole on every rank of its mesh (still a
    DTensor); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    want = [Replicate()] * x.device_mesh.ndim
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def full(x):
    """The global value of a DTensor as a plain tensor on this rank (a
    collective: every rank calls it); a plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def with_logical_constraint(x: torch.Tensor,
                            logical_axes: Sequence[Optional[str]]
                            ) -> torch.Tensor:
    """Redistribute a DTensor activation to the current rules' spec (after
    :func:`divisible_spec`); the identity on a plain tensor, on a mesh of
    one rank, or when ``logical_axes`` does not name every dimension."""
    if not is_dtensor(x) or len(logical_axes) != x.ndim:
        return x
    mesh = x.device_mesh
    if mesh.size() == 1:
        return x
    spec = divisible_spec(logical_spec(logical_axes), tuple(x.shape),
                          mesh_sizes(mesh))
    want = placements(spec, mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(mesh, want)
