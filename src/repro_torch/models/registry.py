"""Config → parameters, forward function and input specs, by model family
(dense, moe, audio, vlm, hybrid, ssm, vit).

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


# families whose inputs the port can describe (every family of the JAX
# package)
INPUT_FAMILIES = ("dense", "moe", "audio", "vlm", "hybrid", "ssm", "vit")


class TensorSpec(NamedTuple):
    """Shape and torch dtype of one model input (the port's stand-in for
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, TensorSpec]:
    """Inputs for (arch × shape): train/prefill take full token sequences
    (train also labels; the stub frontends' memory: whisper's ``frames``
    [B, encoder_seq, d], the vlm's ``image_embeds`` [B, image_tokens, d],
    in the config's dtype), decode one new token (the cache is built
    separately); a ViT takes ``[B, 224, 224, 3]`` f32 images."""
    if cfg.family not in INPUT_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} has no input specs (families: "
            f"{INPUT_FAMILIES})")
    B, N = shape.global_batch, shape.seq_len
    if cfg.family == "vit":
        return {"images": TensorSpec((B, vit_mod.IMAGE, vit_mod.IMAGE, 3),
                                     torch.float32)}
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": TensorSpec((B, N), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = TensorSpec((B, N), torch.int32)
        if cfg.family == "audio":
            specs["frames"] = TensorSpec((B, cfg.encoder_seq, cfg.d_model),
                                         cfg.torch_dtype)
        if cfg.family == "vlm":
            specs["image_embeds"] = TensorSpec(
                (B, cfg.image_tokens, cfg.d_model), cfg.torch_dtype)
        return specs
    return {"tokens": TensorSpec((B, 1), torch.int32)}


def _norm_bytes(cfg: ModelConfig) -> int:
    """One f32 norm: a scale (rmsnorm), or a scale and a bias
    (layernorm)."""
    return cfg.d_model * 4 * (2 if cfg.norm_type == "layernorm" else 1)


def _gqa_bytes(cfg: ModelConfig) -> int:
    """One GQA attention's projections (no bias) in ``cfg.dtype``."""
    return (cfg.d_model * cfg.hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
            * cfg.torch_dtype.itemsize)


def layer_weight_bytes(cfg: ModelConfig) -> Tuple[int, int]:
    """Bytes of one decoder layer's weights → (a layer with a dense MLP: of
    ``d_ff``, or the moe family's first layers' ``moe.d_ff_dense``; a
    layer of experts, or 0): attention (GQA, or MLA's projections) and
    norms, then the MLP (three matrices, two ungated under ``gelu``) or
    the experts (``E`` routed and the shared ones, three matrices each,
    and the f32 router); weights in ``cfg.dtype``, norms f32."""
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
    norms = 2 * _norm_bytes(cfg)
    if cfg.moe is None:
        mats = 2 if cfg.act == "gelu" else 3
        return attn + norms + mats * d * cfg.d_ff * w, 0
    e = cfg.moe
    experts = (3 * d * e.d_ff_expert * (e.n_experts + e.n_shared) * w
               + d * e.n_experts * 4)
    return attn + norms + 3 * d * e.d_ff_dense * w, attn + norms + experts


def _mamba_bytes(cfg: ModelConfig) -> int:
    """One Mamba mixer: its projections and conv in ``cfg.dtype``; the
    time-step bias, A's log and the skip f32."""
    d, S, W = cfg.d_model, cfg.ssm.state_size, cfg.ssm.conv_width
    di = cfg.ssm.expand * d
    w = cfg.torch_dtype.itemsize
    return ((2 * d * di + W * di + 2 * di * S + di * di + di * d) * w
            + (2 * di + di * S) * 4)


def _hymba_layer_bytes(cfg: ModelConfig) -> int:
    """One hymba layer: attention, the Mamba mixer, the MLP and four norms
    (each d wide: hymba runs only at ``n_heads·hd == d``)."""
    w = cfg.torch_dtype.itemsize
    return (_gqa_bytes(cfg) + _mamba_bytes(cfg) + 3 * cfg.d_model * cfg.d_ff * w
            + 4 * _norm_bytes(cfg))


def _xlstm_group_bytes(cfg: ModelConfig) -> int:
    """One xLSTM group: ``slstm_every − 1`` mLSTM blocks (up, q, k, v, the
    gates and down in ``cfg.dtype``, the gate bias and groupnorm scale f32,
    a norm each) and one sLSTM block (input, recurrent and FFN weights,
    f32 bias and scale, its norm)."""
    d, w = cfg.d_model, cfg.torch_dtype.itemsize
    H = cfg.ssm.mlstm_heads
    di = (int(d * cfg.ssm.proj_factor) // H) * H
    du = int(d * 4 / 3)
    mlstm = ((2 * d * di + 3 * di * di + 2 * di * H + di * d) * w
             + (2 * H + di) * 4 + _norm_bytes(cfg))
    slstm = ((4 * d * d + 4 * d * (d // H) + 3 * d * du) * w + 5 * d * 4
             + _norm_bytes(cfg))
    return (cfg.ssm.slstm_every - 1) * mlstm + slstm


def weight_bytes(cfg: ModelConfig) -> int:
    """Bytes of a decoder's weights (``layer_weight_bytes`` over its
    layers, the embedding and the head, the final norm; whisper's encoder
    layers and ``enc_norm`` and each decoder layer's cross-attention and
    its norm; the vlm's cross layers, one a group in place of a dense
    layer, each with its f32 gate)."""
    dense, moe = layer_weight_bytes(cfg)
    head = (cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
            * cfg.torch_dtype.itemsize + _norm_bytes(cfg))
    if cfg.family == "audio":
        return (head + cfg.encoder_layers * dense + _norm_bytes(cfg)
                + cfg.n_layers * (dense + _gqa_bytes(cfg) + _norm_bytes(cfg)))
    if cfg.family == "vlm":
        return head + cfg.n_layers * dense + \
            cfg.n_layers // cfg.cross_attn_every * 4
    if cfg.family == "hybrid":
        return head + cfg.n_layers * _hymba_layer_bytes(cfg)
    if cfg.family == "ssm":
        return head + (cfg.n_layers // cfg.ssm.slstm_every
                       * _xlstm_group_bytes(cfg))
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


def prefill_fn(cfg: ModelConfig) -> Callable:
    """Forward that unembeds only the last position (serving prefill):
    ``fn(params, batch, xcfg) → (logits [B, 1, V], aux)``; the ViT's
    ``forward_fn``."""
    if cfg.family == "vit":
        return forward_fn(cfg)
    return lambda params, batch, xcfg: tfm.forward_lm(params, batch, cfg,
                                                      xcfg, last_only=True)


def decode_fn(cfg: ModelConfig) -> Callable:
    """``fn(params, batch, cache, index, xcfg) → (logits, cache)``: one
    decode step (``transformer.decode_step``); the ViT has none."""
    if cfg.family == "vit":
        raise ValueError("ViT is encoder-only: no decode step (skip decode "
                         "shapes per the brief)")
    return lambda params, batch, cache, idx, xcfg: tfm.decode_step(
        params, batch, cache, idx, cfg, xcfg)


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the meta device: shapes and dtypes,
    no storage."""

    @property
    def device(self):
        return torch.device("meta")


def abstract_params(cfg: ModelConfig):
    """The params tree of ``cfg`` on the meta device: every leaf's shape
    and dtype, nothing allocated (the JAX package's ``jax.eval_shape`` of
    its init)."""
    return init_fn(cfg)(_MetaGenerator())


def abstract_cache(cfg: ModelConfig, shape: ShapeSpec, xcfg=None):
    """The decode cache of (arch × shape) on the meta device, in the JAX
    layout (stacked layers); the memory families' ``mem_kv`` ``[n_stack, B,
    M, Hk, dh]`` and ``mem_mask`` ``[B, M]`` at the memory padded for
    ``xcfg``'s partitions (their slots fill at prefill)."""
    B, S = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    cache = tfm.init_decode_cache(cfg, B, S, device=meta)
    if cfg.family in ("audio", "vlm"):
        shards = xcfg.seq_shards if xcfg is not None else 1
        L = xcfg.L if xcfg is not None else 1
        if cfg.family == "audio":
            M = tfm.pad_len(cfg.encoder_seq, shards, max(L, 1))
            n_stack = cfg.n_layers
        else:
            M = tfm.pad_len(cfg.image_tokens, shards, max(L, 1))
            n_stack = cfg.n_layers // cfg.cross_attn_every
        kv = (n_stack, B, M, cfg.n_kv_heads, cfg.hd)
        cache = {**cache,
                 "mem_kv": {"k": torch.zeros(kv, dtype=cfg.torch_dtype,
                                             device=meta),
                            "v": torch.zeros(kv, dtype=cfg.torch_dtype,
                                             device=meta)},
                 "mem_mask": torch.zeros((B, M), dtype=torch.bool,
                                         device=meta)}
    return cache
