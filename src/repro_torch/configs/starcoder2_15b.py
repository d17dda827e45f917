"""starcoder2-15b [dense]: 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 — GQA, RoPE [arXiv:2402.19173; hf].  GELU MLP + qkv bias per the
StarCoder2 reference implementation."""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    qkv_bias=True,
    mlp="gelu",
    rope_theta=100000.0,
    param_dtype="bfloat16",   # §Perf: halves weight traffic (FSDP gathers + reads)
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
        head_dim=16, d_ff=256, vocab_size=256, dtype="float32",
        param_dtype="float32", remat=False)
