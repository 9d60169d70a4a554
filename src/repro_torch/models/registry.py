"""Config → parameters + forward function (dense family so far).

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


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return tfm.init_lm(cfg, gen)


def forward_fn(cfg: ModelConfig) -> Callable:
    return lambda params, batch, xcfg: tfm.forward_lm(params, batch, cfg, xcfg)
