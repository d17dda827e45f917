"""The LM on PyTorch, serving and training: the reference's ``models``
package for every arch of the registry — dense GQA, MoE, Mamba2 (with Zamba2's shared
attention), RWKV6, the encoder-decoder (Whisper), the vision-stub prefix
(InternVL) and MLA with MTP (DeepSeek-V3): config, layers, attention,
MoE (with the mesh paths), SSD, WKV, the stack, the train, serve and
prefill steps, and weights carried across packages both ways."""
from .attention import MLA, Attention
from .config import (ATTN, MAMBA2, RWKV6, SHARED_ATTN, ModelConfig, MoEConfig,
                     SSMConfig)
from .convert import params_from_jax, params_to_jax
from .moe import MoE, moe_apply
from .rwkv import RWKV6 as RWKV6Mixer
from .ssm import Mamba2, ssd_chunked, ssd_reference
from .stack import (Block, Encoder, MLP, Stack, channel_mix, decode_step,
                    forward_train, init_params, prefill)
from .steps import (MTP_WEIGHT, cross_entropy, init_decode_caches,
                    init_train_state, load_state_tree, loss_fn,
                    make_prefill_step, make_serve_step, make_train_step,
                    state_tree)

__all__ = ["ATTN", "MAMBA2", "RWKV6", "SHARED_ATTN", "ModelConfig",
           "MoEConfig", "SSMConfig", "params_from_jax", "params_to_jax", "MoE",
           "moe_apply",
           "RWKV6Mixer", "Mamba2", "ssd_chunked", "ssd_reference", "MLA",
           "Attention", "Block", "Encoder", "MLP", "Stack", "channel_mix",
           "decode_step", "forward_train", "init_params", "prefill",
           "init_decode_caches", "make_prefill_step", "make_serve_step",
           "MTP_WEIGHT", "cross_entropy", "init_train_state",
           "load_state_tree", "loss_fn", "make_train_step", "state_tree"]
