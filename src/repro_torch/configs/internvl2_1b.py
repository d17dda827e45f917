"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655
— InternViT frontend STUB + Qwen2-0.5B-style backbone [arXiv:2404.16821; hf].

input_specs() provides precomputed patch embeddings (B, 256, 1024); a linear
projector maps them into the LM and they are prepended to the token sequence.
long_500k skipped: full attention.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    mlp="swiglu",
    rope_theta=1000000.0,
    frontend="vision_stub",
    frontend_seq=256,
    frontend_dim=1024,
    tie_embeddings=True,
    param_dtype="bfloat16",   # §Perf: halves weight traffic (FSDP gathers + reads)
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=256, frontend_seq=8,
        frontend_dim=64, dtype="float32", param_dtype="float32", remat=False)
