"""Architecture registry: ``--arch <id>`` ids map to config modules
(dashes in public ids become underscores in module names)."""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import (
    AUDIO,
    DENSE,
    HYBRID,
    LONG_OK_FAMILIES,
    MOE,
    SHAPES,
    SSM,
    VLM,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    ShapeCase,
    XLSTMConfig,
    live_shapes,
)

ARCH_IDS: Tuple[str, ...] = (
    "dbrx-132b",
    "deepseek-v3-671b",
    "llama3-8b",
    "deepseek-coder-33b",
    "gemma2-2b",
    "yi-34b",
    "internvl2-2b",
    "zamba2-2.7b",
    "xlstm-350m",
    "hubert-xlarge",
)

_cache: Dict[str, ModelConfig] = {}


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _cache:
        if arch_id not in ARCH_IDS:
            raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
        mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch_id)}")
        _cache[arch_id] = mod.CONFIG
    return _cache[arch_id]


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = [
    "ARCH_IDS",
    "AUDIO",
    "DENSE",
    "HYBRID",
    "LONG_OK_FAMILIES",
    "MLAConfig",
    "MOE",
    "ModelConfig",
    "MoEConfig",
    "SHAPES",
    "SSM",
    "SSMConfig",
    "ShapeCase",
    "VLM",
    "XLSTMConfig",
    "all_configs",
    "get_config",
    "live_shapes",
]
