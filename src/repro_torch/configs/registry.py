"""Architecture registry: --arch <id> -> ModelConfig."""
from __future__ import annotations

from . import (granite_moe_1b, hubert_xlarge, jamba_52b, llama32_vision_90b,
               mamba2_130m, qwen2_0_5b, qwen2_5_3b, qwen3_moe_235b,
               smollm_135m, starcoder2_15b)
from .base import ModelConfig

_MODULES = {
    "qwen2-0.5b": qwen2_0_5b,
    "starcoder2-15b": starcoder2_15b,
    "smollm-135m": smollm_135m,
    "qwen2.5-3b": qwen2_5_3b,
    "hubert-xlarge": hubert_xlarge,
    "granite-moe-1b-a400m": granite_moe_1b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b,
    "jamba-v0.1-52b": jamba_52b,
    "llama-3.2-vision-90b": llama32_vision_90b,
    "mamba2-130m": mamba2_130m,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = _MODULES[arch]
    return mod.reduced() if reduced else mod.config()
