"""Architecture registry: ``--arch <id>`` resolves here.

Each module defines ``CONFIG`` (the exact published configuration) and
``smoke()`` (a reduced same-family config for CPU tests).  ``SHAPES`` lists
the input-shape cells each arch participates in (long_500k only for
sub-quadratic archs, decode only for archs with a decoder — the skip
rules documented in DESIGN.md §4).  A copy of the reference package's
registry: the same archs, configs and cells.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

from ..models.config import ModelConfig

ARCHS = [
    "zamba2_2p7b",
    "qwen3_32b",
    "starcoder2_15b",
    "qwen2p5_14b",
    "deepseek_coder_33b",
    "deepseek_v3_671b",
    "granite_moe_1b",
    "rwkv6_1p6b",
    "whisper_base",
    "internvl2_1b",
]

# canonical arch ids → module names
ALIASES = {
    "zamba2-2.7b": "zamba2_2p7b",
    "qwen3-32b": "qwen3_32b",
    "starcoder2-15b": "starcoder2_15b",
    "qwen2.5-14b": "qwen2p5_14b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "whisper-base": "whisper_base",
    "internvl2-1b": "internvl2_1b",
}

SHAPES: Dict[str, dict] = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f".{ALIASES.get(arch, arch)}", __package__)
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f".{ALIASES.get(arch, arch)}", __package__)
    return mod.smoke()


def shapes_for(cfg: ModelConfig) -> List[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        out.append("long_500k")
    return out


def all_cells() -> List[Tuple[str, str]]:
    """Every (arch, shape) dry-run cell (skips applied)."""
    cells = []
    for a in ARCHS:
        cfg = get_config(a)
        for s in shapes_for(cfg):
            cells.append((a, s))
    return cells
