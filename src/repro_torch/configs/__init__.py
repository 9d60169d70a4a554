"""Architecture config registry: ``get_config("<arch-id>")``.

The port carries every architecture of the JAX package: the dense
decoders llama3.2-1b, internlm2-1.8b, qwen1.5-32b and gemma2-27b
(windowed local/global layers), the moe family deepseek-moe-16b and
deepseek-v2-236b (MLA attention), the encoder-decoder whisper-large-v3
(audio) and llama-3.2-vision-11b (vlm: cross-attention to image tokens),
hymba-1.5b (hybrid: attention and Mamba heads side by side), xlstm-350m
(ssm: mLSTM and sLSTM blocks), and vit-base-16 (the paper's ViT encoder).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ALL_SHAPES, LONG_CONTEXT_ARCHS,
                                      SHAPES_BY_NAME, MLACfg, ModelConfig,
                                      MoECfg, ShapeSpec, SSMCfg, shapes_for)

_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen1.5-32b": "qwen1_5_32b",
    "gemma2-27b": "gemma2_27b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "whisper-large-v3": "whisper_large_v3",
    "llama-3.2-vision-11b": "llama3_2_vision_11b",
    "hymba-1.5b": "hymba_1_5b",
    "xlstm-350m": "xlstm_350m",
    "vit-base-16": "vit_base",
}
# the decoder LMs (every arch but the paper's ViT), in the JAX package's
# order
ASSIGNED_ARCHS = ("qwen1.5-32b", "llama3.2-1b", "internlm2-1.8b",
                  "gemma2-27b", "deepseek-v2-236b", "deepseek-moe-16b",
                  "whisper-large-v3", "llama-3.2-vision-11b", "hymba-1.5b",
                  "xlstm-350m")


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


__all__ = ["get_config", "ASSIGNED_ARCHS", "ALL_SHAPES", "SHAPES_BY_NAME",
           "ModelConfig", "MoECfg", "MLACfg", "SSMCfg", "ShapeSpec",
           "shapes_for", "LONG_CONTEXT_ARCHS"]
