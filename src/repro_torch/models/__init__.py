"""The LM serve path on PyTorch: the reference's ``models`` package for the
dense GQA family (config, layers, attention, the stack, the serve and
prefill steps, and weights carried over from the reference)."""
from .config import (ATTN, MAMBA2, RWKV6, SHARED_ATTN, ModelConfig, MoEConfig,
                     SSMConfig)
from .convert import params_from_jax
from .stack import (Block, MLP, Stack, decode_step, forward_train,
                    init_params, prefill, unported_features)
from .steps import init_decode_caches, make_prefill_step, make_serve_step

__all__ = ["ATTN", "MAMBA2", "RWKV6", "SHARED_ATTN", "ModelConfig",
           "MoEConfig", "SSMConfig", "params_from_jax", "Block", "MLP",
           "Stack", "decode_step", "forward_train", "init_params", "prefill",
           "unported_features", "init_decode_caches", "make_prefill_step",
           "make_serve_step"]
