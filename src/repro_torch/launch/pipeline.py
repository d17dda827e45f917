"""GPipe-style pipeline parallelism over the ``pod`` axis, the reference's
``launch/pipeline.py`` on ``torch.distributed``.

Across pods the data-centre network is too slow for per-layer
collectives; a pipeline sends only a layer's activations across pods,
once per microbatch:

* the layer stack is split into ``n_stages`` contiguous stages along
  ``pod`` (:func:`stage_layers`);
* each tick, stage 0 takes in microbatch ``t``, every stage runs its
  layers on what it holds, the last stage emits microbatch
  ``t - (n_stages - 1)``, and each stage sends its activations to the
  next (``batch_isend_irecv``, the reference's ``ppermute``) — the only
  traffic across pods, one (microbatch, seq, d_model) block a tick;
* after ``n_micro + n_stages - 1`` ticks every microbatch has passed
  every stage.

As in the reference, two stages (a pod axis of 2) and dense attention
blocks; another pod size above one is refused, and without a pod axis (or
at one rank along it) the whole stack runs as one stage.  Each rank
returns its own output buffer, as each of the reference's devices holds
its own: the last stage's holds every microbatch's output, the other
stages' stay zero.  (The reference's global output reads stage 0's
buffer, which is zero: ROADMAP Queue 3.)

The dry run at 2×16×16 on a fake process group prints the bytes each
rank sends and receives::

    python -m repro_torch.launch.pipeline --arch qwen2.5-14b [--n-micro 4]
"""
from __future__ import annotations

import argparse
import json
from typing import List

import torch
import torch.distributed as dist

from ..configs import ALIASES, get_config
from ..models.config import ATTN

N_STAGES = 2


def stage_layers(num_layers: int, n_stages: int, stage: int) -> range:
    """The layers of ``stage``: contiguous, ``num_layers / n_stages``
    each."""
    if num_layers % n_stages:
        raise ValueError(f"{num_layers} layers do not split into "
                         f"{n_stages} stages")
    per = num_layers // n_stages
    return range(stage * per, (stage + 1) * per)


def _stages(mesh, axis: str) -> int:
    n = mesh.axis_size(axis) if axis in mesh.axis_names else 1
    if n not in (1, N_STAGES):
        raise ValueError(f"the pipeline runs {N_STAGES} stages over "
                         f"{axis!r}, not {n}")
    return n


def _exchange(cur: torch.Tensor, nxt: int, prv: int, group
              ) -> torch.Tensor:
    """Send ``cur`` to rank ``nxt`` and receive the previous stage's from
    ``prv`` (global ranks), both posted together."""
    buf = torch.empty_like(cur)
    cur = cur.contiguous()
    if cur.device.type == "meta":
        # batching needs a device backend; meta has none (the dry run)
        reqs = [dist.isend(cur, nxt, group), dist.irecv(buf, prv, group)]
    else:
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, cur, nxt, group),
            dist.P2POp(dist.irecv, buf, prv, group)])
    for r in reqs:
        r.wait()
    return buf


def pipeline_forward(blocks: List, cfg, x: torch.Tensor, *, n_micro: int,
                     mesh, axis: str = "pod") -> torch.Tensor:
    """Forward through this rank's stage of dense attention ``blocks``
    under ``mesh`` (a :class:`~repro_torch.launch.mesh.ModelMesh`).

    ``x``: (n_micro, micro_batch, seq, d_model), this rank's block of the
    microbatches (over ``data``, as the reference shards them).  Returns
    this rank's output buffer of ``x``'s shape: on the last stage every
    microbatch through every stage, zero elsewhere."""
    if any(getattr(b, "kind", ATTN) != ATTN or "mlp" not in b
           for b in blocks):
        raise ValueError("the pipeline runs dense attention blocks only")
    n_stages = _stages(mesh, axis)

    def run_stage(h):
        for blk in blocks:
            h, _ = blk(h)
        return h

    if n_stages == 1:
        return torch.stack([run_stage(x[m]) for m in range(n_micro)])
    stage = mesh.axis_index(axis)
    group = mesh.groups[axis]
    peers = dist.get_process_group_ranks(group)
    nxt, prv = peers[(stage + 1) % n_stages], peers[(stage - 1) % n_stages]
    buf = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(n_micro + n_stages - 1):
        if stage == 0:
            # stage 0 ingests microbatch t (zeros once they run out)
            cur = x[t] if t < n_micro else torch.zeros_like(buf)
        else:
            cur = buf
        cur = run_stage(cur)
        done = t - (n_stages - 1)
        if done >= 0 and stage == n_stages - 1:
            outs[done] = cur
        # rotate activations to the next stage (the inter-pod hop)
        buf = _exchange(cur, nxt, prv, group)
    return outs


def main(argv=None) -> dict:
    from ..models import init_params
    from .dryrun import CostMode, production_mesh
    from .mesh import model_mesh_from

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--n-micro", type=int, default=4)
    args = ap.parse_args(argv)

    arch = ALIASES.get(args.arch, args.arch)
    cfg = get_config(arch)
    mesh = model_mesh_from(production_mesh("pods2x16x16"))
    stage = mesh.axis_index("pod")
    model, _ = init_params(cfg, 0, "meta")
    blocks = [model.blocks[i]
              for i in stage_layers(cfg.num_layers, N_STAGES, stage)]
    micro_b, seq = 32, 1024          # 32 % data(16) == 0
    x = torch.empty((args.n_micro, micro_b // mesh.axis_size("data"), seq,
                     cfg.d_model), dtype=cfg.activation_dtype,
                    device="meta")
    mode = CostMode()
    with torch.no_grad(), mode:
        out = pipeline_forward(blocks, cfg, x, n_micro=args.n_micro,
                               mesh=mesh)
    params = sum(p.numel() * p.element_size()
                 for b in blocks for p in b.parameters())
    rec = {"arch": arch, "mesh": "pods2x16x16", "n_micro": args.n_micro,
           "stage": stage, "stage_layers": len(blocks),
           "argument_size_in_bytes": params + x.numel() * x.element_size(),
           "output_size_in_bytes": out.numel() * out.element_size(),
           "flops": float(mode.flops),
           "collective_permute_bytes": float(
               mode.collectives["collective-permute"])}
    print("pipeline dry run ran OK")
    print("collective-permute bytes (inter-pod activations, sent and "
          f"received): {rec['collective_permute_bytes']:.3e}")
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
