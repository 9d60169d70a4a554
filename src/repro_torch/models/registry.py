"""Config → parameters, forward function and input specs, by model family
(dense, moe, vit).

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
INPUT_FAMILIES = ("dense", "moe", "vit")


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


def layer_weight_bytes(cfg: ModelConfig) -> Tuple[int, int]:
    """Bytes of one decoder layer's weights → (a layer with a dense MLP: of
    ``d_ff``, or the moe family's first layers' ``moe.d_ff_dense``; a
    layer of experts, or 0): attention (GQA, or MLA's projections) and
    norms, then the MLP or the experts (``E`` routed and the shared ones,
    three matrices each, and the f32 router); weights in ``cfg.dtype``,
    norms f32."""
    d, hd, w = cfg.d_model, cfg.hd, cfg.torch_dtype.itemsize
    if cfg.mla is not None:
        m, H = cfg.mla, cfg.n_heads
        attn = (d * m.q_lora_rank
                + m.q_lora_rank * H * (m.qk_nope_dim + m.qk_rope_dim)
                + d * (m.kv_lora_rank + m.qk_rope_dim)
                + m.kv_lora_rank * H * (m.qk_nope_dim + m.v_head_dim)
                + H * m.v_head_dim * d) * w \
            + (m.q_lora_rank + m.kv_lora_rank) * 4
    else:
        attn = (d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
                + (hd * (cfg.n_heads + 2 * cfg.n_kv_heads)
                   if cfg.qkv_bias else 0)) * w
    norms = 2 * d * 4
    if cfg.moe is None:
        return attn + norms + 3 * d * cfg.d_ff * w, 0
    e = cfg.moe
    experts = (3 * d * e.d_ff_expert * (e.n_experts + e.n_shared) * w
               + d * e.n_experts * 4)
    return attn + norms + 3 * d * e.d_ff_dense * w, attn + norms + experts


def weight_bytes(cfg: ModelConfig) -> int:
    """Bytes of a decoder's weights (``layer_weight_bytes`` over its
    layers, the embedding and the head, the final norm)."""
    dense, moe = layer_weight_bytes(cfg)
    head = (cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
            * cfg.torch_dtype.itemsize + cfg.d_model * 4)
    if cfg.moe is None:
        return head + cfg.n_layers * dense
    fd = cfg.moe.first_dense_layers
    return head + fd * dense + (cfg.n_layers - fd) * moe


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
