"""Config → parameters + forward function, by model family (dense, vit).

Port of ``repro.models.registry``.  ``init_params`` is the port's own
initialisation: the JAX package's distributions, drawn from a
``torch.Generator`` seeded with ``seed`` on the target device.  It does not
reproduce JAX's random numbers; parity tests carry the JAX weights across
with ``repro_torch.models.bridge.params_from_numpy`` instead.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models import vit as vit_mod


def init_fn(cfg: ModelConfig) -> Callable:
    """``fn(gen) → params`` for the config's family."""
    if cfg.family == "vit":
        return lambda gen: vit_mod.init_vit(cfg, gen)
    return lambda gen: tfm.init_lm(cfg, gen)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return init_fn(cfg)(gen)


def forward_fn(cfg: ModelConfig) -> Callable:
    """``fn(params, batch, xcfg) → (output, aux)``: logits over the tokens
    of ``batch["tokens"]``, or class logits of ``batch["images"]``."""
    if cfg.family == "vit":
        return lambda params, batch, xcfg: (
            vit_mod.forward_vit(params, batch["images"], cfg, xcfg),
            torch.zeros((), dtype=torch.float32,
                        device=batch["images"].device))
    return lambda params, batch, xcfg: tfm.forward_lm(params, batch, cfg, xcfg)
