"""deepseek-coder-33b [dense]: 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256 — llama-arch [arXiv:2401.14196; hf]."""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    mlp="swiglu",
    rope_theta=100000.0,
    param_dtype="bfloat16",   # §Perf: halves weight traffic (FSDP gathers + reads)
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
        head_dim=16, d_ff=256, vocab_size=256, dtype="float32",
        param_dtype="float32", remat=False)
