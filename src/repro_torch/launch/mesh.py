"""Process groups of the sharded stream engine, and the LM's model mesh,
on ``torch.distributed``.

The counterpart of the reference package's mesh module.  JAX is
single-controller: one program splits a global array over a ``Mesh``.
PyTorch is SPMD: every rank is a process that holds its own block.  Rank
``r`` of ``n`` holds rows ``[r·N/n, (r+1)·N/n)`` of the sharded axis (the
lanes of a scan, the events of a router chunk), which is the block layout
of the reference's ``PartitionSpec(axes)``; gathering the ranks' outputs in
rank order gives the reference's global array element for element
(:meth:`StreamGroup.block`, :meth:`StreamGroup.gather`).

The stream engine's group is flat: one rank per GPU of the job, NCCL
between the GPUs, or gloo on the CPU.

The LM needs the reference's named axes instead: :class:`ModelMesh`
(``data`` and ``model``, ``pod`` across pods) over a named
``DeviceMesh``, with ``axis_index``, ``psum``, ``pmean`` and
``all_gather`` over one axis (:func:`init_model_mesh`), or of one rank
with no group at all (:func:`host_model_mesh`, the reference's
``make_host_mesh()``).  :func:`production_shape` and
:func:`init_production_mesh` give the reference's production meshes
(16×16, 2×16×16) for the launchers.  :func:`use_model_mesh` enters one,
as ``jax.set_mesh`` does.

Stream groups are initialised through a ``file://`` store at a path the caller
gives (a path that does not exist yet, on a file system every rank
sees), so concurrent jobs on one host never race for a TCP port, and
always with an explicit timeout, so a rank that never arrives fails the
others instead of hanging them.
"""
from __future__ import annotations

import math
import os
from contextlib import contextmanager
from dataclasses import dataclass
from datetime import timedelta
from typing import List, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = timedelta(seconds=120)


@dataclass
class StreamGroup:
    """One rank's view of the group: its rank, the world size, the device
    its blocks live on, the backend and the process group."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    group: dist.ProcessGroup

    def block(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block of ``x``'s axis ``dim`` (whose length the
        world size must divide): rows ``[r·N/n, (r+1)·N/n)``."""
        N = x.shape[dim]
        if N % self.world_size:
            raise ValueError(f"axis {dim} of length {N} does not split into "
                             f"{self.world_size} equal blocks")
        n = N // self.world_size
        return x.narrow(dim, self.rank * n, n)

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's block of one axis, concatenated in rank order (a
        collective: every rank calls it with a block of the same shape).
        Returns the global tensor on this rank's device."""
        dtype = x.dtype
        # bool and uint32 travel as bytes and int32 bits (gloo takes
        # neither)
        if dtype == torch.bool:
            x = x.to(torch.uint8)
        elif dtype == torch.uint32:
            x = x.view(torch.int32)
        x = x.to(self.device).contiguous()
        parts: List[torch.Tensor] = [torch.empty_like(x)
                                     for _ in range(self.world_size)]
        dist.all_gather(parts, x, group=self.group)
        out = torch.cat(parts, dim)
        if dtype == torch.bool:
            return out.bool()
        return out.view(torch.uint32) if dtype == torch.uint32 else out

    def close(self) -> None:
        """Destroy the process group (every rank calls it)."""
        dist.destroy_process_group(self.group)


def init_stream_group(store: str, *, rank: int, world_size: int,
                      backend: str, device,
                      timeout: timedelta = DEFAULT_TIMEOUT) -> StreamGroup:
    """Join a group of ``world_size`` ranks as ``rank`` through the file
    store at ``store`` (absolute or relative path; every rank gives the
    same one), with collectives on ``backend`` (``"nccl"`` or ``"gloo"``)
    and blocks on ``device``."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"NCCL groups place blocks on a CUDA device, "
                             f"got {device}")
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method="file://" + os.path.abspath(store), rank=rank,
        world_size=world_size, timeout=timeout)
    return StreamGroup(rank, world_size, device, backend,
                       dist.group.WORLD)


def make_host_mesh(store: str, *,
                   timeout: timedelta = DEFAULT_TIMEOUT) -> StreamGroup:
    """A group of one rank on the CPU (gloo), for tests."""
    return init_stream_group(store, rank=0, world_size=1, backend="gloo",
                             device="cpu", timeout=timeout)


def make_production_mesh(store: str, *, device: Optional[str] = None,
                         timeout: timedelta = DEFAULT_TIMEOUT
                         ) -> StreamGroup:
    """The job's group: rank, world size and local rank from the
    variables ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``;
    without them, a group of one).  Blocks live on ``cuda:LOCAL_RANK``
    with NCCL, which raises ``RuntimeError`` without a CUDA device, or on
    the CPU with gloo when ``device="cpu"``."""
    env = os.environ
    rank = int(env.get("RANK", 0))
    world = int(env.get("WORLD_SIZE", 1))
    local = int(env.get("LOCAL_RANK", 0))
    if device is not None and torch.device(device).type == "cpu":
        return init_stream_group(store, rank=rank, world_size=world,
                                 backend="gloo", device="cpu",
                                 timeout=timeout)
    if device is not None and torch.device(device).type != "cuda":
        raise ValueError(f"groups run on CUDA or the CPU, got {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("make_production_mesh runs on CUDA and no CUDA "
                           "device is available; pass device='cpu' for the "
                           "CPU")
    return init_stream_group(store, rank=rank, world_size=world,
                             backend="nccl", device=f"cuda:{local}",
                             timeout=timeout)


# ---------------------------------------------------------------------------
# the model mesh: named axes for the LM's expert-parallel MoE paths
# ---------------------------------------------------------------------------


class ModelMesh:
    """The reference's ``("data", "model")`` mesh (``("pod", "data",
    "model")`` across pods) on ``torch.distributed``, as one rank sees it.

    Rank ``r`` sits at the row-major coordinates of ``shape``, the order
    in which the reference lays devices on its mesh, so rank ``d·M + m``
    of a ``data × model = D × M`` mesh is at ``(d, m)``.  ``device_mesh``
    is the named ``DeviceMesh`` of the same ranks and axis names (None for
    a mesh of one rank with no process group); DTensor state is placed
    over it (``sharding.specs``), and each axis of more than one rank
    takes its process group from it (``DeviceMesh.get_group``): the ranks
    that differ from this one along that axis only.  An axis of size 1
    has no group, and its collectives are the identity, so a mesh of one
    rank runs on one card or on the CPU with nothing initialised.
    Collectives carry gradients: sums through
    ``torch.distributed.nn.functional``, gathers through
    :class:`_AllGather`."""

    def __init__(self, shape, rank: int = 0, groups=None,
                 device_mesh=None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.rank = rank
        self.device_mesh = device_mesh
        self.groups = dict(groups or {})
        coords, rest = {}, rank
        for name in reversed(self.axis_names):
            coords[name] = rest % self.shape[name]
            rest //= self.shape[name]
        if rest:
            raise ValueError(f"rank {rank} outside a mesh of shape "
                             f"{self.shape}")
        self.coords = coords
        for name, n in self.shape.items():
            if n > 1 and self.groups.get(name) is None:
                raise ValueError(f"axis {name!r} of {n} ranks needs a "
                                 f"process group")

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_size(self, name: str) -> int:
        return self.shape[name]

    def axis_index(self, name: str) -> int:
        return self.coords[name]

    def psum(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """The sum of ``x`` over the ranks of axis ``name``."""
        if self.shape[name] == 1:
            return x
        from torch.distributed.nn import functional as dfn
        return dfn.all_reduce(x, group=self.groups[name])

    def pmean(self, x: torch.Tensor, names) -> torch.Tensor:
        """The mean of ``x`` over the ranks of the axes ``names``."""
        n = 1
        for name in names:
            x = self.psum(x, name)
            n *= self.shape[name]
        return x / n if n > 1 else x

    def all_gather(self, x: torch.Tensor, name: str, dim: int = 0
                   ) -> torch.Tensor:
        """Every rank's ``x`` along axis ``name``, concatenated on ``dim``
        in the order of the axis (the reference's ``tiled`` gather)."""
        if self.shape[name] == 1:
            return x
        parts = _AllGather.apply(x, self.groups[name])
        return torch.cat(list(parts.unbind(0)), dim=dim)


class _AllGather(torch.autograd.Function):
    """Every rank's ``x`` of ``group`` stacked on a new leading dim, in
    group-rank order; the gradient of each rank's ``x`` is its block of
    the gradient summed over the ranks (a reduce-scatter).
    ``torch.distributed.nn``'s all-gather takes its gradient on gloo by
    scatters that name their source by its rank in the group, which gloo
    reads as a global rank, so it fails in a subgroup."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.shape = group, x.shape
        n = dist.get_world_size(group)
        out = x.new_empty(n * x.numel())
        dist.all_gather_into_tensor(out, x.contiguous().view(-1),
                                    group=group)
        return out.view((n,) + tuple(x.shape))

    @staticmethod
    def backward(ctx, grad):
        out = grad.new_empty(ctx.shape.numel())
        dist.reduce_scatter_tensor(out, grad.contiguous().view(-1),
                                   group=ctx.group)
        return out.view(ctx.shape), None


def host_model_mesh() -> ModelMesh:
    """The mesh of one rank, ``data`` 1 × ``model`` 1: the reference's
    ``make_host_mesh()``, which both of its launchers enter."""
    return ModelMesh({"data": 1, "model": 1})


def model_mesh_from(device_mesh) -> ModelMesh:
    """The :class:`ModelMesh` of a named ``DeviceMesh``: its axes, this
    rank's coordinates, and each axis's group from the mesh."""
    names = tuple(device_mesh.mesh_dim_names)
    shape = dict(zip(names, device_mesh.mesh.shape))
    coords = device_mesh.get_coordinate()
    rank = 0
    for name, c in zip(names, coords):
        rank = rank * shape[name] + int(c)
    groups = {n: device_mesh.get_group(n) for n in names if shape[n] > 1}
    return ModelMesh(shape, rank, groups, device_mesh)


def init_model_mesh(shape, rank: int) -> ModelMesh:
    """A mesh of ``shape`` (ordered ``{axis: size}``) over the job's
    default process group, which must hold exactly that many ranks when
    one is initialised; without one, only the mesh of one rank, with no
    ``DeviceMesh``.  Every rank calls it, with the same shape.  The
    ``DeviceMesh`` lays the ranks row-major and makes each axis's groups
    (on CUDA under NCCL, else on the CPU)."""
    shape = dict(shape)
    n = math.prod(shape.values())
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"a mesh of {n} ranks needs a process group")
        return ModelMesh(shape, 0)
    if dist.get_world_size() != n:
        raise ValueError(f"a mesh of {n} ranks over a world of "
                         f"{dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, tuple(shape.values()),
                          mesh_dim_names=tuple(shape))
    mesh = model_mesh_from(dm)
    if mesh.rank != rank:
        raise ValueError(f"rank {rank} sits at mesh rank {mesh.rank}")
    return mesh


PRODUCTION_SHAPES = {
    (1, False): {"data": 1, "model": 1},
    (1, True): {"pod": 1, "data": 1, "model": 1},
    (256, False): {"data": 16, "model": 16},
    (512, True): {"pod": 2, "data": 16, "model": 16},
}


def production_shape(world: int, multi_pod: bool = False) -> dict:
    """The reference's production mesh for a world of ``world`` ranks:
    ``data`` 16 × ``model`` 16 for 256, ``pod`` 2 × ``data`` 16 ×
    ``model`` 16 for 512 with ``multi_pod``, the mesh of one rank for a
    world of one.  Any other world raises."""
    shape = PRODUCTION_SHAPES.get((world, bool(multi_pod)))
    if shape is None:
        raise ValueError(
            f"the production mesh takes a world of 256 ranks (16×16, "
            f"data × model), 512 with --multi-pod (2×16×16, pod × data × "
            f"model), or 1 (the mesh of one rank); got {world}"
            + (" with --multi-pod" if multi_pod else ""))
    return dict(shape)


def init_production_mesh(*, multi_pod: bool = False, device=None,
                         timeout: timedelta = DEFAULT_TIMEOUT
                         ) -> ModelMesh:
    """Join the job's group (the variables ``torchrun`` sets: ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``; without them a world
    of one through a file store in a new temporary directory) unless a
    default group exists, and build the production mesh of its world
    (:func:`production_shape`) with its ``DeviceMesh``.  NCCL with blocks
    on ``cuda:LOCAL_RANK``, or gloo when ``device`` is the CPU."""
    env = os.environ
    world = dist.get_world_size() if dist.is_initialized() else int(
        env.get("WORLD_SIZE", 1))
    shape = production_shape(world, multi_pod)
    if not dist.is_initialized():
        rank = int(env.get("RANK", 0))
        cpu = device is not None and torch.device(device).type == "cpu"
        if not cpu:
            torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
        if "MASTER_ADDR" in env:
            init = "env://"
        else:
            import tempfile
            init = "file://" + os.path.join(tempfile.mkdtemp(), "store")
        dist.init_process_group("gloo" if cpu else "nccl",
                                init_method=init, rank=rank,
                                world_size=world, timeout=timeout)
    return init_model_mesh(shape, dist.get_rank())


_MESHES: List[ModelMesh] = []


@contextmanager
def use_model_mesh(mesh: Optional[ModelMesh]):
    """Run the LM under ``mesh`` (the reference's ``jax.set_mesh``): MoE
    layers then take the expert-parallel paths.  ``None`` leaves the model
    off the mesh."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def current_model_mesh() -> Optional[ModelMesh]:
    """The innermost mesh entered by :func:`use_model_mesh`, or None."""
    return _MESHES[-1] if _MESHES else None
