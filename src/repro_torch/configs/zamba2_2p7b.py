"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention block.

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf].  The shared transformer block (one parameter set,
GQA + MLP) is invoked every 6th layer — real Zamba2 also concatenates the
original embedding into the shared-block input and applies per-invocation
LoRA deltas; both are simplified away here (DESIGN.md §4).
Sub-quadratic backbone ⇒ runs long_500k.
"""
import dataclasses

from ..models.config import MAMBA2, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    block_kind=MAMBA2,
    ssm=SSMConfig(state_dim=64, num_heads=80, head_dim=64, conv_width=4,
                  chunk=256, expand=2),
    shared_attn_every=6,
    mlp="gelu",
    rope_theta=10000.0,
    supports_long_context=True,
    param_dtype="bfloat16",   # §Perf: halves weight traffic (FSDP gathers + reads)
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=12, d_model=128, num_heads=4, num_kv_heads=4,
        head_dim=0, d_ff=256, vocab_size=256,
        ssm=SSMConfig(state_dim=16, num_heads=4, head_dim=64, conv_width=4,
                      chunk=8, expand=2),
        shared_attn_every=3, dtype="float32", param_dtype="float32",
        remat=False)
