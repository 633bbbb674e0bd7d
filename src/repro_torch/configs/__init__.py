"""Architecture registry: ``--arch <id>`` -> ArchConfig."""

from __future__ import annotations

from .base import SHAPES, ArchConfig, ShapeCell, smoke_shape

_MODULES = {
    "tinyllama-1.1b": "tinyllama_1_1b",
    "llama3.2-1b": "llama3_2_1b",
    "gemma-7b": "gemma_7b",
    "qwen2-1.5b": "qwen2_1_5b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "mamba2-130m": "mamba2_130m",
    "grok-1-314b": "grok_1_314b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}

ARCH_NAMES = list(_MODULES)


def get_config(name: str) -> ArchConfig:
    import importlib
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.CONFIG


__all__ = ["ARCH_NAMES", "SHAPES", "ArchConfig", "ShapeCell", "get_config",
           "smoke_shape"]
