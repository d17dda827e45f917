"""End-to-end training driver on the PyTorch port: a ~100M-parameter
model, a few hundred steps, the fault-tolerant loop with checkpointing and
a CER training monitor.

    PYTHONPATH=src python examples/torch_train_small.py [--steps 300]
        [--arch qwen3-32b] [--batch 8] [--seq 128] [--device cpu]

The counterpart of ``examples/train_small.py``: the same config (the
arch's family scaled to ~100M parameters), monitor and spike rule, and
the same lines printed.  It trains on the CUDA device unless ``--device
cpu`` asks for the CPU.
"""
import argparse
import dataclasses
import tempfile

from repro_torch.configs import ALIASES, get_config
from repro_torch.core import compile_query
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import init_train_state, make_train_step
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import Trainer, TrainerConfig

MONITOR = """
SELECT * FROM Metrics
WHERE STEP AS a ; STEP AS b ; STEP AS c
FILTER a[spike > 0] AND b[spike > 0] AND c[spike > 0]
WITHIN 20 events
"""


def small_config(arch: str):
    cfg = get_config(ALIASES.get(arch, arch))
    return dataclasses.replace(
        cfg, num_layers=4, d_model=512,
        num_heads=8, num_kv_heads=max(1, min(cfg.num_kv_heads, 4)),
        head_dim=64, d_ff=1536, vocab_size=8192,
        moe=None, first_dense_layers=0, mtp_depth=0,
        shared_attn_every=0, block_kind="attn", encoder_layers=0,
        cross_attention=False, frontend="none",
        dtype="float32", param_dtype="float32", remat=False)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="qwen3-32b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="cpu to train on the CPU; default the CUDA device")
    args = ap.parse_args(argv)

    cfg = small_config(args.arch)
    total, _ = cfg.param_counts()
    print(f"model: {cfg.name} family, {total/1e6:.1f}M params")

    opt = AdamWConfig(lr=3e-4, total_steps=args.steps, warmup_steps=20)
    state, _ = init_train_state(cfg, opt, 0, device=args.device)
    step = make_train_step(cfg, opt)
    data = TokenPipeline(cfg.vocab_size, args.batch, args.seq, seed=0,
                         device=args.device)

    # CER monitor over training metrics: 3 loss spikes within 20 steps
    last = {"loss": None}

    def step_with_spike(state, batch):
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        spike = 1.0 if (last["loss"] is not None and
                        loss > 1.02 * last["loss"]) else 0.0
        last["loss"] = loss
        metrics = dict(metrics, spike=spike)
        return state, metrics

    monitor = compile_query(MONITOR).make_executor(max_enumerate=1)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(
            step_with_spike, state, data,
            TrainerConfig(total_steps=args.steps, checkpoint_every=100,
                          checkpoint_dir=ckpt_dir),
            monitors=[monitor])
        report = trainer.run()
    first, final = trainer.metrics_log[0], trainer.metrics_log[-1]
    print(f"loss: {first['loss']:.3f} → {final['loss']:.3f} over "
          f"{report['final_step']} steps "
          f"(median step {report['median_step_time']*1e3:.0f} ms)")
    print(f"CER monitor fired {report['monitor_matches']} times "
          f"(loss-spike triple within 20 steps)")
    assert final["loss"] < first["loss"]
    return {"report": report, "metrics": trainer.metrics_log}


if __name__ == "__main__":
    main()
