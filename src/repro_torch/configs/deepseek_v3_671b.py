"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff=2048(expert)
vocab=129280, MoE 256e top-8 — MLA, 1 shared + 256 routed, MTP
[arXiv:2412.19437; hf].

MLA: q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
qk_rope_head_dim=64, v_head_dim=128.  First 3 layers dense (d_ff=18432).
Optimizer moments in bf16 — fp32 m/v would not fit 512×16 GB.
"""
import dataclasses

from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,            # qk nope head dim
    d_ff=18432,              # dense layers (first 3)
    vocab_size=129280,
    attention="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    rope_head_dim=64,
    v_head_dim=128,
    mlp="swiglu",
    moe=MoEConfig(num_experts=256, top_k=8, d_ff=2048,
                  num_shared_experts=1, shared_d_ff=2048,
                  capacity_factor=1.25),
    first_dense_layers=3,
    mtp_depth=1,
    rope_theta=10000.0,
    # bf16 master weights + bf16 moments: fp32 anything would exceed the
    # 16 GB/chip of a 256-chip v5e pod (params alone are 2.7 TB in fp32).
    param_dtype="bfloat16",
    opt_state_dtype="bfloat16",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
        head_dim=32, d_ff=256, vocab_size=256,
        q_lora_rank=64, kv_lora_rank=32, rope_head_dim=16, v_head_dim=32,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff=64, num_shared_experts=1,
                      shared_d_ff=64, capacity_factor=4.0),
        first_dense_layers=1, mtp_depth=1, dtype="float32",
        param_dtype="float32", opt_state_dtype="float32", remat=False)
