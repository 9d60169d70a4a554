"""Architecture config registry: ``get_config("<arch-id>")``.

The port carries llama3.2-1b (dense) and vit-base-16 (the paper's ViT
encoder) so far; the other architectures of the JAX package arrive with
their model families.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ALL_SHAPES, LONG_CONTEXT_ARCHS,
                                      SHAPES_BY_NAME, MLACfg, ModelConfig,
                                      MoECfg, ShapeSpec, SSMCfg, shapes_for)

_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
    "vit-base-16": "vit_base",
}

# archs of the JAX package that the port does not carry yet
_PENDING = ("qwen1.5-32b", "internlm2-1.8b", "gemma2-27b", "deepseek-v2-236b",
            "deepseek-moe-16b", "whisper-large-v3", "llama-3.2-vision-11b",
            "hymba-1.5b", "xlstm-350m")


def get_config(name: str) -> ModelConfig:
    if name in _PENDING:
        raise KeyError(f"arch {name!r} is not ported yet: its family is "
                       f"queued in ROADMAP queue 1 (items 4 and 11); "
                       f"ported: {sorted(_MODULES)}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


__all__ = ["get_config", "ALL_SHAPES", "SHAPES_BY_NAME",
           "ModelConfig", "MoECfg", "MLACfg", "SSMCfg", "ShapeSpec",
           "shapes_for", "LONG_CONTEXT_ARCHS"]
