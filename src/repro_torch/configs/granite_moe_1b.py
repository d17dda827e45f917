"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
import dataclasses

from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    mlp="swiglu",
    moe=MoEConfig(num_experts=32, top_k=8, d_ff=512, capacity_factor=1.25),
    rope_theta=10000.0,
    tie_embeddings=True,
    param_dtype="bfloat16",   # §Perf: halves weight traffic (FSDP gathers + reads)
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=64, vocab_size=256,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff=64, capacity_factor=4.0),
        dtype="float32", param_dtype="float32", remat=False)
