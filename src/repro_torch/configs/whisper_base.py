"""whisper-base [audio]: 6L enc + 6L dec, d_model=512 8H d_ff=2048
vocab=51865 — enc-dec, conv frontend STUB [arXiv:2212.04356; unverified].

input_specs() provides precomputed frame embeddings (B, 1500, 512) — the
mel+conv frontend is out of scope.  Decode shapes lower
the decoder's serve_step (self-attn KV cache of seq_len + static cross-attn
KV over the 1500 encoder frames).  long_500k skipped: full attention.
"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    mlp="gelu",
    encoder_layers=6,
    encoder_seq=1500,
    cross_attention=True,
    frontend="audio_stub",
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256, encoder_layers=2,
        encoder_seq=30, dtype="float32", param_dtype="float32", remat=False)
