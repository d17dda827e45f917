"""Multi-pod dry run of the port: every (arch × shape × mesh) cell's step
on meta tensors placed as DTensors over a fake process group of the
mesh's size, the reference's ``launch/dryrun.py`` on PyTorch.

For each cell this builds meta inputs (``launch/specs.py``, no
allocation), places them by the logical-axis rules over a ``DeviceMesh``
of 256 (``pod16x16``: ``data`` 16 × ``model`` 16) or 512 ranks
(``pods2x16x16``: ``pod`` 2 × ``data`` 16 × ``model`` 16) on the ``fake``
backend, runs the step the launchers run (train: forward, backward and
the AdamW update; prefill; one decode step) as rank 0 of that group (over
pods, on its pod's replica of the state and its half of the batch, the
gradients averaged over ``pod``: ``sharding.specs.state_mesh``), and
records:

* the bytes per device of the arguments and the outputs, from the local
  blocks' shapes (``memory_analysis``).  Meta tensors have no
  allocator, so there is no compiler ``temp`` figure: it is ``null``;
* the FLOPs per device, counted on the local blocks: a dispatch mode
  below DTensor sees each op at the shapes this rank computes
  (``flops``), with the bytes each op reads and writes (``bytes
  accessed``, every op's operands and results, as an eager program moves
  them);
* the collective bytes per device, by kind: each collective's local
  result (``all-gather`` the gathered block, ``reduce-scatter`` the
  scattered one, ``all-reduce`` and ``all-to-all`` the tensor,
  ``collective-permute`` a send or a receive);
* the seconds the step took to run on meta (``lower_s``).

Attention runs as one block of the whole sequence here (the step's
chunked loop has the same FLOPs, and a block's scores take no memory on
meta), so ``bytes accessed`` counts the score matrix once whole.  Every
op is dispatched and counted, so a cell takes seconds to a minute on one
core, but RWKV6's train_4k and prefill_32k, whose WKV recurrence is a
loop over 4 096 and 32 768 positions, take minutes.  Values
on a fake group are meaningless: a collective there returns without
moving data.  The figures describe the port's program as one rank runs
it, not measurements of 256 cards.

Records go to ``REPRO_RESULTS_DIR``, by default ``build/dryrun/``, as
``<arch>__<shape>__<mesh>.json``.  No card is needed::

    python -m repro_torch.launch.dryrun --arch granite-moe-1b-a400m \\
        --shape train_4k [--multi-pod]
    python -m repro_torch.launch.dryrun --all [--multi-pod-only |
        --single-pod-only] [--keep-going]

The fake group is the process's default group, so run the dry run in a
process of its own (never inside a process that holds another group).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from contextlib import ExitStack, contextmanager
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ALIASES, SHAPES, all_cells, get_config
from ..sharding import (DECODE_RULES, LONG_DECODE_RULES, TRAIN_RULES,
                        AxisRules, set_rules)
from ..sharding.specs import local_bytes, place

RESULTS_DIR = os.environ.get(
    "REPRO_RESULTS_DIR",
    os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                 "dryrun"))

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

MESHES = {"pod16x16": {"data": 16, "model": 16},
          "pods2x16x16": {"pod": 2, "data": 16, "model": 16}}

# collective ops by qualified name → kind
_COLL_OPS = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_c10d_functional::isend": "collective-permute",
    "_c10d_functional::irecv": "collective-permute",
    "c10d::allreduce_": "all-reduce",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::alltoall_": "all-to-all",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::send": "collective-permute",
    "c10d::recv_": "collective-permute",
}

# which operand of a c10d op holds the result (outputs first)
_C10D_RESULT_ARG = {"c10d::allreduce_": 0, "c10d::allgather_": 0,
                    "c10d::_allgather_base_": 0,
                    "c10d::allgather_into_tensor_coalesced_": 0,
                    "c10d::reduce_scatter_": 0,
                    "c10d::_reduce_scatter_base_": 0, "c10d::alltoall_": 0,
                    "c10d::alltoall_base_": 0, "c10d::send": 0,
                    "c10d::recv_": 0}


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    return 0


# ops that allocate and move no data
_ALLOCATIONS = {"aten::empty", "aten::empty_strided", "aten::empty_like",
                "aten::new_empty", "aten::new_empty_strided"}


def _is_view(func) -> bool:
    """Whether an op returns a view of an operand (no data moves)."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _operands(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from (t for t in a if isinstance(t, torch.Tensor))


class CostMode(TorchDispatchMode):
    """Counts, on the local blocks, the FLOPs, the bytes read and written
    and the collective bytes by kind of every op dispatched under it.

    An op on DTensors is handed back to DTensor first (``NotImplemented``),
    which runs it as local ops and collectives on this rank's blocks; those
    come back here and are counted at the shapes this rank computes.  Only
    ops on ``device`` (the dry run's meta tensors) count: DTensor plans a
    redistribution with small host tensors, and infers an op's shapes on
    fake tensors, the first time it meets the op.  FLOPs follow ``torch.utils.flop_counter``'s formulas (matmul, batched
    matmul, convolution, attention)."""

    def __init__(self, device: str = "meta"):
        super().__init__()
        self.device = torch.device(device)
        from torch.utils.flop_counter import flop_registry
        self._registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives = {k: 0 for k in COLLECTIVES}
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types) or not any(
                t.device == self.device for t in _operands((out,) + args)):
            # DTensor's planning for an op it has not seen yet (shape
            # inference on fake tensors at global shapes, index bookkeeping
            # on host tensors): not this rank's work
            return out
        packet = func._overloadpacket
        name = getattr(packet, "_qualified_op_name", str(packet))
        kind = _COLL_OPS.get(name)
        if kind is not None:
            if name.startswith("c10d::"):
                res = args[_C10D_RESULT_ARG[name]]
            else:
                res = out
            self.collectives[kind] += _tensor_bytes(res)
            return out
        self.ops += 1
        if packet in self._registry:
            self.flops += int(self._registry[packet](*args, **kwargs,
                                                     out_val=out))
        if not _is_view(func) and name not in _ALLOCATIONS:
            self.bytes += sum(_tensor_bytes(t) for t in _operands(args))
            self.bytes += _tensor_bytes(out)
        return out


# ---------------------------------------------------------------------------
# meshes on the fake process group
# ---------------------------------------------------------------------------


def fake_world(world: int) -> None:
    """Make the process's default group a fake one of ``world`` ranks, this
    process rank 0 (closing any fake group of another size first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_mesh(shape: Dict[str, int]):
    """A ``DeviceMesh`` of ``shape`` ({axis: size}, row-major ranks) over
    the default group, which must hold exactly that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape.values()),
                            mesh_dim_names=tuple(shape))


def production_mesh(mesh_name: str):
    """The named production mesh on a fake group of its size."""
    shape = MESHES[mesh_name]
    n = 1
    for s in shape.values():
        n *= s
    fake_world(n)
    return make_mesh(shape)


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def rules_for(shape_name: str, cfg=None) -> AxisRules:
    """Sharding rules per shape.

    With REPRO_OPT_RULES=1, decode shapes drop the fsdp axis whenever the
    parameter shards fit TP-only (≤ 6 GB per device across the 16-way
    model axis), so a decode step gathers no parameter."""
    if shape_name == "train_4k":
        return TRAIN_RULES
    base = LONG_DECODE_RULES if shape_name == "long_500k" else DECODE_RULES
    if cfg is not None and os.environ.get("REPRO_OPT_RULES") == "1":
        total, _ = cfg.param_counts()
        dtype_bytes = 2 if "bf16" in cfg.param_dtype or \
            "bfloat16" in cfg.param_dtype else 4
        if total * dtype_bytes / 16 <= 6e9:   # fits TP-16 without fsdp
            return AxisRules(tuple(
                (k, None if k == "fsdp" else v) for k, v in base.rules))
    return base


def collective_bytes(mode: CostMode) -> Dict[str, Any]:
    """Per-device collective bytes by kind, as the run under ``mode`` issued
    them (every collective is dispatched, so nothing is scaled by a loop
    count); ``ops`` kept for the reference's schema."""
    out: Dict[str, Any] = {k: float(v) for k, v in mode.collectives.items()}
    out["ops"] = {}
    return out


@contextmanager
def one_block_attention():
    """Attention in one block of the whole sequence (the same FLOPs as the
    chunked loop; on meta a block takes no memory)."""
    from ..models import attention
    q, k = attention.ATTN_CHUNK_Q, attention.ATTN_CHUNK_K
    attention.set_chunk_sizes(1 << 30, 1 << 30)
    try:
        yield
    finally:
        attention.set_chunk_sizes(q, k)


def place_inputs(spec: Dict[str, Any], rules: AxisRules, mesh
                 ) -> Dict[str, Any]:
    """The cell's meta inputs placed as DTensors over ``mesh`` by
    ``rules``."""
    out = dict(spec)
    if spec["kind"] == "train":
        out["state"] = place(spec["state"], spec["state_axes"], rules, mesh)
    else:
        out["params"] = place(spec["params"], spec["param_axes"], rules,
                              mesh)
    if "batch" in spec:
        out["batch"] = place(spec["batch"], spec["batch_axes"], rules, mesh)
    if spec["kind"] == "decode":
        out["caches"] = place(spec["caches"], spec["cache_axes"], rules,
                              mesh)
        out["token"] = place({"token": spec["token"]},
                             {"token": ("batch", None)}, rules,
                             mesh)["token"]
    return out


def run_step(cfg, placed: Dict[str, Any], rules: AxisRules, mesh,
             seq_len: int) -> Tuple[Any, Any]:
    """Run the cell's step on the placed inputs → (arguments, outputs)."""
    from ..models import make_prefill_step, make_serve_step, make_train_step
    from .mesh import model_mesh_from, use_model_mesh
    with ExitStack() as stack:
        stack.enter_context(set_rules(rules))
        stack.enter_context(use_model_mesh(model_mesh_from(mesh)))
        if placed["kind"] == "train":
            step = make_train_step(cfg, placed["opt_cfg"])
            args = (placed["state"], placed["batch"])
            out = step(*args)
        elif placed["kind"] == "prefill":
            step = make_prefill_step(cfg)
            args = (placed["params"], placed["batch"])
            out = step(*args)
        else:
            step = make_serve_step(cfg)
            args = (placed["params"], placed["token"], placed["caches"])
            out = step(placed["params"], placed["token"], placed["caches"],
                       seq_len - 1)
    return args, out


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str,
             save: bool = True, verbose: bool = True,
             cfg=None, shape: Optional[Dict[str, Any]] = None
             ) -> Dict[str, Any]:
    """One cell on ``mesh`` (a ``DeviceMesh`` on a fake group; see
    :func:`production_mesh`) → its record, written to ``RESULTS_DIR``
    when ``save``.  ``cfg`` replaces the arch's published config (the
    cost model's variants, a depth cut), ``shape`` the named shape's
    ``kind``, ``seq_len`` and ``global_batch``."""
    from .specs import input_specs
    cfg = cfg or get_config(arch)
    rules = rules_for(shape_name, cfg)
    shape = shape or SHAPES[shape_name]
    t0 = time.time()
    with set_rules(rules):
        spec = input_specs(cfg, shape_name, shape)
        placed = place_inputs(spec, rules, mesh)
    arg_bytes = None
    mode = CostMode()
    with one_block_attention():
        if spec["kind"] == "train":
            # the update writes the state in place: count it before
            arg_bytes = local_bytes(placed["state"]) + \
                local_bytes(placed["batch"])
        with mode:
            args, out = run_step(cfg, placed, rules, mesh,
                                 shape["seq_len"])
    t_lower = time.time() - t0
    if arg_bytes is None:
        arg_bytes = local_bytes(args)
    mem = {"argument_size_in_bytes": int(arg_bytes),
           "output_size_in_bytes": int(local_bytes(out)),
           "temp_size_in_bytes": None,
           "temp_note": "meta tensors have no allocator; no temp figure"}
    total, active = cfg.param_counts()
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": spec["kind"],
        "num_devices": int(mesh.size()),
        "seq_len": shape["seq_len"],
        "global_batch": shape["global_batch"],
        "params_total": total, "params_active": active,
        "flops": float(mode.flops),
        "bytes_accessed": float(mode.bytes),
        "cost_analysis": {"flops": float(mode.flops),
                          "bytes accessed": float(mode.bytes),
                          "local_ops": mode.ops},
        "memory_analysis": mem,
        "collectives": collective_bytes(mode),
        "hlo_chars": 0,
        "lower_s": round(t_lower, 2), "compile_s": 0.0,
        "source": "repro_torch dry run: local-block counts of one rank on "
                  "a fake process group, attention in one block",
    }
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} × {mesh_name}: "
              f"run {t_lower:.1f}s flops={record['flops']:.3e} "
              f"bytes={record['bytes_accessed']:.3e}")
        print(f"  memory_analysis: {mem}")
        print(f"  collectives: "
              f"{ {k: v for k, v in record['collectives'].items() if k != 'ops'} }")
    if save:
        os.makedirs(RESULTS_DIR, exist_ok=True)
        path = os.path.join(RESULTS_DIR,
                            f"{arch}__{shape_name}__{mesh_name}.json")
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
    return record


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2×16×16 multi-pod mesh for --arch/--shape")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--keep-going", action="store_true")
    args = ap.parse_args(argv)

    meshes = []
    if not args.multi_pod_only:
        meshes.append("pod16x16")
    if not args.single_pod_only:
        meshes.append("pods2x16x16")

    if args.all:
        cells = all_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        arch = ALIASES.get(args.arch, args.arch)
        cells = [(arch, args.shape)]
        if args.multi_pod:
            meshes = ["pods2x16x16"]

    failures, records = [], []
    for mesh_name in meshes:
        mesh = production_mesh(mesh_name)
        for arch, shape in cells:
            try:
                records.append(run_cell(arch, shape, mesh, mesh_name))
            except Exception as e:
                failures.append((arch, shape, mesh_name, repr(e)))
                print(f"[dryrun] FAIL {arch} × {shape} × {mesh_name}: {e}")
                if not args.keep_going:
                    traceback.print_exc()
                    raise
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nall dry-run cells ran OK")
    return records


if __name__ == "__main__":
    main()
