"""Unified model configuration covering all ten architecture families.

A copy of the reference package's ``models/config.py``: every field keeps
its name, default and string value, so one ``ModelConfig`` describes the
same model in both packages.  It covers dense / GQA / MLA attention,
SwiGLU / GELU MLPs, MoE layers, Mamba2 and RWKV6 token mixers, Zamba2-style
shared attention blocks, encoder-decoder (Whisper) and stub modality
frontends; :mod:`repro_torch.models.stack` runs the dense GQA family and
refuses the rest (:func:`repro_torch.models.stack.unported_features`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import torch

def torch_dtype(name: str) -> torch.dtype:
    """The ``torch.dtype`` a config's dtype string names (``"bfloat16"``,
    ``"float32"``, ...)."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"not a torch dtype: {name!r}")
    return dtype


# block kinds
ATTN = "attn"
MAMBA2 = "mamba2"
RWKV6 = "rwkv6"
SHARED_ATTN = "shared_attn"   # zamba2: one weight set, invoked at many depths


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    d_ff: int = 0                 # per-expert hidden
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64           # mamba2 N / rwkv head size
    num_heads: int = 0            # mamba2 heads (0 = derive d_model//64)
    head_dim: int = 64
    conv_width: int = 4
    chunk: int = 64               # SSD chunk length
    expand: int = 2               # d_inner = expand * d_model


@dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 = d_model // num_heads

    # attention options
    attention: str = "gqa"        # gqa | mla | none
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # MLA (deepseek-v3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 0

    # mlp
    mlp: str = "swiglu"           # swiglu | gelu
    moe: Optional[MoEConfig] = None
    first_dense_layers: int = 0   # dsv3: first k layers dense even in MoE nets

    # mixers
    block_kind: str = ATTN        # default mixer: attn | mamba2 | rwkv6
    ssm: Optional[SSMConfig] = None
    shared_attn_every: int = 0    # zamba2: shared attn block period (0 = off)

    # encoder-decoder / frontends
    encoder_layers: int = 0       # whisper
    encoder_seq: int = 1500       # whisper: 30 s of audio at 50 Hz
    cross_attention: bool = False
    frontend: str = "none"        # none | audio_stub | vision_stub
    frontend_seq: int = 0         # patches / frames provided by the stub
    frontend_dim: int = 0

    # extras
    mtp_depth: int = 0            # deepseek-v3 multi-token prediction
    vocab_pad_multiple: int = 0   # pad the unembedding to ×N so logits can
                                  # shard over `model` (pad cols masked -1e9)
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    norm_eps: float = 1e-6

    # numerics / training
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    opt_state_dtype: str = "float32"   # big models use bfloat16 moments
    remat: bool = True
    scan_layers: bool = True

    # which shapes are valid for this arch (long_500k only sub-quadratic)
    supports_long_context: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(1, self.num_heads))
        if self.v_head_dim == 0:
            object.__setattr__(self, "v_head_dim", self.head_dim)

    # ------------------------------------------------------------------
    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def padded_vocab(self) -> int:
        if not self.vocab_pad_multiple:
            return self.vocab_size
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    def layer_kinds(self) -> List[str]:
        """Per-layer mixer kinds for the decoder stack."""
        kinds = []
        for i in range(self.num_layers):
            if self.shared_attn_every and i % self.shared_attn_every == \
                    self.shared_attn_every - 1:
                kinds.append(SHARED_ATTN)
            else:
                kinds.append(self.block_kind)
        return kinds

    def layer_is_moe(self, i: int) -> bool:
        return self.moe is not None and i >= self.first_dense_layers

    def segments(self) -> List[Tuple[str, bool, int]]:
        """Group consecutive identical (kind, is_moe) layers for scan.

        Returns a list of (kind, is_moe, count).
        """
        out: List[Tuple[str, bool, int]] = []
        for i, kind in enumerate(self.layer_kinds()):
            moe = self.layer_is_moe(i)
            if out and out[-1][0] == kind and out[-1][1] == moe:
                out[-1] = (kind, moe, out[-1][2] + 1)
            else:
                out.append((kind, moe, 1))
        return out

    # parameter counts (for roofline MODEL_FLOPS) ------------------------
    def param_counts(self) -> Tuple[int, int]:
        """(total_params, active_params_per_token) — embeddings excluded
        from the 6·N·D rule's N by convention? We include all matmul params
        (embedding lookup is a gather; lm_head is a matmul and is included).
        """
        d, h, kv, hd = self.d_model, self.num_heads, self.num_kv_heads, self.head_dim
        total = active = 0

        def attn_params() -> int:
            if self.attention == "mla":
                qr = self.q_lora_rank or d
                p = d * qr + qr * h * (self.head_dim + self.rope_head_dim)
                p += d * (self.kv_lora_rank + self.rope_head_dim)
                p += self.kv_lora_rank * h * (self.head_dim + self.v_head_dim)
                p += h * self.v_head_dim * d
                return p
            return d * h * hd + 2 * d * kv * hd + h * hd * d

        def dense_mlp() -> int:
            mult = 3 if self.mlp == "swiglu" else 2
            return mult * d * self.d_ff

        def moe_mlp() -> Tuple[int, int]:
            m = self.moe
            mult = 3 if self.mlp == "swiglu" else 2
            router = d * m.num_experts
            per_expert = mult * d * m.d_ff
            shared = m.num_shared_experts * mult * d * m.shared_d_ff
            tot = router + m.num_experts * per_expert + shared
            act = router + m.top_k * per_expert + shared
            return tot, act

        def mamba_params() -> int:
            s = self.ssm
            d_in = s.expand * d
            nh = s.num_heads or d_in // s.head_dim
            in_proj = d * (2 * d_in + 2 * s.state_dim + nh)   # z, x, B, C, dt
            conv = s.conv_width * (d_in + 2 * s.state_dim)
            out_proj = d_in * d
            return in_proj + conv + out_proj + 3 * d_in

        def rwkv_params() -> int:
            # r,k,v,g,o projections + decay/mix LoRAs (approx)
            return 5 * d * d + 2 * d * 64

        def rwkv_cmix() -> int:
            return 2 * d * self.d_ff + d * d

        kinds = self.layer_kinds()
        shared_counted = False
        for i, kind in enumerate(kinds):
            if kind == ATTN:
                # attention blocks carry the FFN slot (dense or MoE)
                p = attn_params()
                total += p
                active += p
                if self.layer_is_moe(i):
                    t, a = moe_mlp()
                    total += t
                    active += a
                else:
                    p = dense_mlp()
                    total += p
                    active += p
            elif kind == SHARED_ATTN:
                # one parameter set, invoked at many depths
                p = attn_params() + dense_mlp()
                if not shared_counted:
                    total += p
                    shared_counted = True
                active += p
            elif kind == MAMBA2:
                # mixer-only block (no separate FFN)
                p = mamba_params()
                total += p
                active += p
            elif kind == RWKV6:
                # time-mix + squared-relu channel-mix
                p = rwkv_params() + rwkv_cmix()
                total += p
                active += p
        # embeddings + head
        emb = self.vocab_size * d
        total += emb if self.tie_embeddings else 2 * emb
        active += emb if self.tie_embeddings else 2 * emb
        # encoder (whisper)
        if self.encoder_layers:
            enc = self.encoder_layers * (attn_params() + dense_mlp())
            total += enc
            active += enc
        if self.cross_attention:
            cross = self.num_layers * attn_params()
            total += cross
            active += cross
        if self.mtp_depth:
            p = self.mtp_depth * (attn_params() + dense_mlp() + 2 * d * d)
            total += p
            active += p
        return int(total), int(active)
