"""Training launcher, the reference's ``launch/train.py`` on PyTorch.

    python -m repro_torch.launch.train --arch qwen3-32b [--steps 100]
        [--global-batch B] [--seq-len S] [--smoke] [--multi-pod]
        [--compress-grads] [--checkpoint-dir DIR] [--checkpoint-every N]
        [--device cpu]
    torchrun --nproc-per-node 8 --nnodes 32 ... \\
        -m repro_torch.launch.train --arch qwen3-32b

It runs on the CUDA device unless ``--device cpu`` asks for the CPU, and
raises without a card.  ``--smoke`` takes the arch's reduced config
(batch 8 × 64 tokens by default) on the mesh of one rank (the reference's
``make_host_mesh()``), with plain tensors.  Without it the published
config, at ``train_4k``'s batch and length unless ``--global-batch`` and
``--seq-len`` say otherwise, on the production mesh of the job's world
(``launch.mesh.production_shape``): ``data`` 16 × ``model`` 16 for 256
ranks, ``pod`` 2 × ``data`` 16 × ``model`` 16 for 512 with
``--multi-pod``, the mesh of one rank for a world of one; any other world
raises.  There the train state is placed as DTensors by ``sharding_tree``
under ``TRAIN_RULES`` (parameters and moments over ``data`` as FSDP and
``model`` as TP), each batch is split over ``pod`` and ``data``, and
DTensor's sharding propagation runs the step (``models.steps``).  Every
rank draws the state from the seed one parameter at a time and keeps
its blocks as it goes (``sharding.specs.drawn_in_place``).  MoE
layers take the reference launcher's expert-parallel paths on the local
blocks: the weights-stationary pass at 512 tokens or fewer over the
mesh, the sharded pass with per-rank capacity above.  Checkpoints hold
full tensors: each leaf is gathered in turn, and rank 0 copies it to
the host and writes them.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch.distributed as dist

from ..configs import ALIASES, SHAPES, get_config, get_smoke_config
from ..data.tokens import TokenPipeline
from ..models import init_train_state, make_train_step
from ..optim import AdamWConfig
from ..runtime import Trainer, TrainerConfig
from ..sharding import TRAIN_RULES, set_rules
from ..sharding.specs import drawn_in_place, place
from ..vector.engine import resolve_device
from .mesh import host_model_mesh, init_production_mesh, use_model_mesh
from .serve import set_matmul_precision
from .specs import batch_axes


class PlacedBatches:
    """A batch source whose batches are placed over ``mesh`` by
    ``rules`` (the batch split over ``pod`` and ``data``): every rank
    draws the same global batch and keeps its block."""

    def __init__(self, data, cfg, mesh, rules):
        self.data, self.cfg, self.mesh, self.rules = data, cfg, mesh, rules

    def batch_at(self, step: int):
        batch = self.data.batch_at(step)
        return place(batch, batch_axes(self.cfg), self.rules,
                     self.mesh.device_mesh)


def train_state_on_mesh(cfg, opt_cfg, mesh, *, seed: int = 0,
                        compress: bool = False, device=None,
                        rules=TRAIN_RULES):
    """The train state from ``seed`` placed as DTensors over ``mesh`` (a
    :class:`~repro_torch.launch.mesh.ModelMesh` with a ``DeviceMesh``)
    by ``rules``; returns (state, axes).  Each parameter keeps this
    rank's block as it is drawn, and the moments are made on the
    parameters' placements, so no rank holds the whole state."""
    with drawn_in_place(cfg, rules, mesh.device_mesh):
        state, axes = init_train_state(cfg, opt_cfg, seed,
                                       compress=compress, device=device)
    return place(state, axes, rules, mesh.device_mesh), axes


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config on the mesh of one rank")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2×16×16 mesh (pod × data × model) of 512 "
                         "ranks; at a world of one, the mesh of one rank")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--checkpoint-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU; default the CUDA device")
    args = ap.parse_args(argv)

    set_matmul_precision()
    device = resolve_device(args.device)
    arch = ALIASES.get(args.arch, args.arch)
    cfg = get_smoke_config(arch) if args.smoke else get_config(arch)
    B = args.global_batch or (8 if args.smoke else
                              SHAPES["train_4k"]["global_batch"])
    S = args.seq_len or (64 if args.smoke else SHAPES["train_4k"]["seq_len"])
    opt_cfg = AdamWConfig(total_steps=args.steps,
                          moment_dtype=cfg.opt_state_dtype)
    frontend = {}
    if cfg.frontend == "vision_stub":
        frontend["patches"] = (cfg.frontend_seq, cfg.frontend_dim)
    if cfg.encoder_layers:
        frontend["frames"] = (cfg.encoder_seq, cfg.d_model)
    data = TokenPipeline(cfg.vocab_size, B, S, seed=0, frontend=frontend,
                         device=device)
    owns_group = False
    if args.smoke:
        mesh = host_model_mesh()
    else:
        owns_group = not dist.is_initialized()
        mesh = init_production_mesh(multi_pod=args.multi_pod, device=device)
    try:
        with set_rules(TRAIN_RULES), use_model_mesh(mesh):
            if args.smoke:
                state, _ = init_train_state(cfg, opt_cfg, 0,
                                            compress=args.compress_grads,
                                            device=device)
            else:
                state, _ = train_state_on_mesh(
                    cfg, opt_cfg, mesh, compress=args.compress_grads,
                    device=device)
                data = PlacedBatches(data, cfg, mesh, TRAIN_RULES)
            step = make_train_step(cfg, opt_cfg,
                                   compress=args.compress_grads)
            trainer = Trainer(
                step, state, data,
                TrainerConfig(total_steps=args.steps,
                              checkpoint_every=args.checkpoint_every,
                              checkpoint_dir=args.checkpoint_dir))
            report = trainer.run()
    finally:
        if owns_group:
            dist.destroy_process_group()
    print(f"done: {report}")
    return {"report": report, "metrics": trainer.metrics_log,
            "mesh": dict(mesh.shape)}


if __name__ == "__main__":
    main()
