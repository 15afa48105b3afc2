"""Architecture config registry (``--arch <id>``)."""
from __future__ import annotations

from importlib import import_module

from .base import (LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K, DECODE_32K,
                   ModelConfig, ShapeConfig, reduced)

_ARCH_MODULES = {
    "command-r-35b": "command_r_35b",
    "yi-6b": "yi_6b",
    "nemotron-4-340b": "nemotron_4_340b",
    "internlm2-1.8b": "internlm2_1_8b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "internvl2-1b": "internvl2_1b",
    "rwkv6-7b": "rwkv6_7b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}").CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cells(arch: str) -> list[str]:
    """Shape names applicable to an arch (assignment skip rules)."""
    cfg = get_config(arch)
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out
