"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936 — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    mlp="swiglu",
    rope_theta=1000000.0,
    param_dtype="bfloat16",   # §Perf: halves weight traffic (FSDP gathers + reads)
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
        head_dim=16, d_ff=256, vocab_size=256, dtype="float32",
        param_dtype="float32", remat=False)
