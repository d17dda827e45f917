"""Training launcher, the reference's ``launch/train.py`` on PyTorch.

    python -m repro_torch.launch.train --arch qwen3-32b [--steps 100]
        [--global-batch B] [--seq-len S] [--smoke] [--compress-grads]
        [--checkpoint-dir DIR] [--checkpoint-every N] [--device cpu]

It runs on the CUDA device unless ``--device cpu`` asks for the CPU, and
raises without a card.  The model runs under the mesh of one rank (the
reference's ``make_host_mesh()``), so MoE layers take the reference
launcher's expert-parallel paths: the weights-stationary pass at 512
tokens or fewer, the sharded pass with per-rank capacity above.
``--smoke`` takes the arch's reduced config (batch 8 × 64 tokens by
default); without it the published config, at ``train_4k``'s batch and
length unless ``--global-batch`` and ``--seq-len`` say otherwise.  The
reference's production mesh spans many devices; the port's multi-device
training (``--multi-pod``, sharded parameters) is not written yet and the
flag raises.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from ..configs import ALIASES, SHAPES, get_config, get_smoke_config
from ..data.tokens import TokenPipeline
from ..models import init_train_state, make_train_step
from ..optim import AdamWConfig
from ..runtime import Trainer, TrainerConfig
from ..vector.engine import resolve_device
from .mesh import host_model_mesh, use_model_mesh
from .serve import set_matmul_precision


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config on the mesh of one rank")
    ap.add_argument("--multi-pod", action="store_true",
                    help="not available: multi-device training is not "
                         "ported yet")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--checkpoint-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU; default the CUDA device")
    args = ap.parse_args(argv)
    if args.multi_pod:
        raise SystemExit("--multi-pod: the port trains on one device; its "
                         "multi-device training (sharding/, the pipeline "
                         "and the production mesh) is not written yet")

    set_matmul_precision()
    device = resolve_device(args.device)
    arch = ALIASES.get(args.arch, args.arch)
    cfg = get_smoke_config(arch) if args.smoke else get_config(arch)
    B = args.global_batch or (8 if args.smoke else
                              SHAPES["train_4k"]["global_batch"])
    S = args.seq_len or (64 if args.smoke else SHAPES["train_4k"]["seq_len"])
    opt_cfg = AdamWConfig(total_steps=args.steps,
                          moment_dtype=cfg.opt_state_dtype)

    with use_model_mesh(host_model_mesh()):
        state, _ = init_train_state(cfg, opt_cfg, 0,
                                    compress=args.compress_grads,
                                    device=device)
        step = make_train_step(cfg, opt_cfg, compress=args.compress_grads)
        frontend = {}
        if cfg.frontend == "vision_stub":
            frontend["patches"] = (cfg.frontend_seq, cfg.frontend_dim)
        if cfg.encoder_layers:
            frontend["frames"] = (cfg.encoder_seq, cfg.d_model)
        data = TokenPipeline(cfg.vocab_size, B, S, seed=0, frontend=frontend,
                             device=device)
        trainer = Trainer(
            step, state, data,
            TrainerConfig(total_steps=args.steps,
                          checkpoint_every=args.checkpoint_every,
                          checkpoint_dir=args.checkpoint_dir))
        report = trainer.run()
    print(f"done: {report}")
    return {"report": report, "metrics": trainer.metrics_log}


if __name__ == "__main__":
    main()
