"""Config → parameters, forward function and input specs, by model family
(dense, vit).

Port of ``repro.models.registry``.  ``init_params`` is the port's own
initialisation: the JAX package's distributions, drawn from a
``torch.Generator`` seeded with ``seed`` on the target device.  It does not
reproduce JAX's random numbers; parity tests carry the JAX weights across
with ``repro_torch.models.bridge.params_from_numpy`` instead.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import transformer as tfm
from repro_torch.models import vit as vit_mod


# families whose inputs the port can describe; the others arrive with their
# models (ROADMAP queue 1 item [11])
INPUT_FAMILIES = ("dense", "vit")


class TensorSpec(NamedTuple):
    """Shape and torch dtype of one model input (the port's stand-in for
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, TensorSpec]:
    """Inputs for (arch × shape): train/prefill take full token sequences
    (train also labels), decode one new token (the cache is built
    separately); a ViT takes ``[B, 224, 224, 3]`` f32 images."""
    if cfg.family not in INPUT_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} has no input specs in the port yet "
            f"(supported: {INPUT_FAMILIES}; the other families are ROADMAP "
            f"queue 1 item [11])")
    B, N = shape.global_batch, shape.seq_len
    if cfg.family == "vit":
        return {"images": TensorSpec((B, vit_mod.IMAGE, vit_mod.IMAGE, 3),
                                     torch.float32)}
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": TensorSpec((B, N), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = TensorSpec((B, N), torch.int32)
        return specs
    return {"tokens": TensorSpec((B, 1), torch.int32)}


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
