"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free) d_ff=7168 vocab=65536
— Finch, data-dependent decay [arXiv:2404.05892; unverified].
O(1) state ⇒ runs long_500k."""
import dataclasses

from ..models.config import RWKV6, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    num_layers=24,
    d_model=2048,
    num_heads=32,            # d_model / 64 rwkv heads
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    block_kind=RWKV6,
    supports_long_context=True,
    param_dtype="bfloat16",   # §Perf: halves weight traffic (FSDP gathers + reads)
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=128, num_heads=2, num_kv_heads=2,
        head_dim=0, d_ff=256, vocab_size=256, dtype="float32",
        param_dtype="float32", remat=False)
