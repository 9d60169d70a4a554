"""Transformer stacks — the dense decoder family (llama / qwen / internlm).

Port of ``repro.models.transformer`` for ``family == "dense"`` without
local–global alternation.  Layer parameters are a Python list of per-layer
dicts walked in a loop (in place of the JAX package's stacked ``lax.scan``
layout); the decode cache keeps the stacked ``[n_layers, B, S, Hk, dh]``
layout, and each layer updates its slice of it in place.

Entry points:
  init_lm(cfg, gen)                        → params dict
  forward_lm(params, batch, cfg, xcfg)     → (logits, aux)   full forward
  init_decode_cache(cfg, B, S, device)     → cache dict
  prefill(params, batch, cache, cfg, xcfg) → (last logits, primed cache)
  decode_step(params, batch, cache, i, cfg, xcfg) → (logits, cache)

The other families (moe, mla, hybrid, ssm, audio, vlm) and gemma2's
windowed layers are ROADMAP queue 1 items 6 and 11.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.exchange import ExchangeConfig, exchange_attention
from repro_torch.models.layers import (AttnSpec, apply_mlp, apply_norm,
                                       attention_block, attention_decode,
                                       embed, init_attention, init_embedding,
                                       init_kv_cache, init_mlp, init_norm,
                                       prefill_kv_cache, project_qkv, unembed)

Params = Dict[str, Any]

# single-pass prefill is defined for the attention-cached families the port
# carries; the rest prefill by the teacher-forced decode loop
PREFILL_FAMILIES = ("dense",)


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.local_global:
        raise NotImplementedError(
            f"family {cfg.family!r} (local_global={cfg.local_global}) is not "
            f"ported yet (ROADMAP queue 1 items 6 and 11)")


def _attn_spec(cfg: ModelConfig, *, window: Optional[int] = None,
               causal: Optional[bool] = None, use_rope: bool = True) -> AttnSpec:
    return AttnSpec(
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
        causal=cfg.causal if causal is None else causal,
        window=window, logit_softcap=cfg.attn_softcap,
        rope_theta=cfg.rope_theta, use_rope=use_rope and cfg.rope_theta > 0,
        scale=cfg.query_scale)


def pad_len(n: int, shards: int, L: int) -> int:
    """Pad a memory length so each of ``shards`` partitions splits into L
    integer segments (mask-aware means handle the remainder exactly)."""
    q = shards * max(L, 1)
    return ((n + q - 1) // q) * q


# ---------------------------------------------------------------------------
# dense layer init / apply
# ---------------------------------------------------------------------------

def _init_dense_layer(cfg: ModelConfig, gen: torch.Generator) -> Params:
    d, dtype, dev = cfg.d_model, cfg.torch_dtype, gen.device
    p = {"ln1": init_norm(cfg.norm_type, d, dev),
         "attn": init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                dtype, qkv_bias=cfg.qkv_bias),
         "ln2": init_norm(cfg.norm_type, d, dev),
         "mlp": init_mlp(gen, d, cfg.d_ff, dtype, gated=cfg.act != "gelu")}
    if cfg.post_norms:
        p["post_attn"] = init_norm(cfg.norm_type, d, dev)
        p["post_mlp"] = init_norm(cfg.norm_type, d, dev)
    return p


def _mlp_residual(p: Params, x, h, cfg: ModelConfig):
    """Shared tail of every block: x + h, then x + mlp(ln2(x))."""
    if cfg.post_norms:
        h = apply_norm(cfg.norm_type, p["post_attn"], h)
    x = x + h
    h2 = apply_mlp(p["mlp"], apply_norm(cfg.norm_type, p["ln2"], x), cfg.act)
    if cfg.post_norms:
        h2 = apply_norm(cfg.norm_type, p["post_mlp"], h2)
    return x + h2


def _apply_attn_mlp(p: Params, x, cfg: ModelConfig, xcfg, spec: AttnSpec,
                    positions):
    """Standard pre-norm block: x + attn(ln(x)); x + mlp(ln(x))."""
    h = attention_block(p["attn"], apply_norm(cfg.norm_type, p["ln1"], x),
                        spec, xcfg, positions=positions)
    return _mlp_residual(p, x, h, cfg)


def _apply_attn_mlp_prefill(p: Params, x, cfg: ModelConfig, xcfg,
                            spec: AttnSpec, positions, cache):
    """Full-sequence block that also writes the prompt K/V into the decode
    cache — same math as ``_apply_attn_mlp``."""
    xin = apply_norm(cfg.norm_type, p["ln1"], x)
    q, k, v = project_qkv(p["attn"], xin, spec, positions)
    prefill_kv_cache(cache, k, v)
    attn = exchange_attention(q, k, v, xcfg, causal=spec.causal,
                              window=spec.window,
                              logit_softcap=spec.logit_softcap,
                              scale=spec.scale)
    B, N = x.shape[:2]
    h = attn.reshape(B, N, spec.n_heads * spec.head_dim) @ p["attn"]["wo"]
    return _mlp_residual(p, x, h, cfg)


def _apply_attn_mlp_decode(p: Params, x, cfg: ModelConfig, xcfg,
                           spec: AttnSpec, cache, index: int):
    h, _ = attention_decode(p["attn"],
                            apply_norm(cfg.norm_type, p["ln1"], x), spec,
                            xcfg, cache, index)
    return _mlp_residual(p, x, h, cfg)


# ---------------------------------------------------------------------------
# model init
# ---------------------------------------------------------------------------

def init_lm(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Dense decoder parameters drawn from ``gen`` on its device."""
    _require_dense(cfg)
    d, dtype = cfg.d_model, cfg.torch_dtype
    params: Params = {
        "embed": init_embedding(gen, cfg.vocab_size, d, dtype),
        "final_norm": init_norm(cfg.norm_type, d, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embedding(gen, cfg.vocab_size, d, dtype)
    params["layers"] = [_init_dense_layer(cfg, gen)
                        for _ in range(cfg.n_layers)]
    return params


def _head(params: Params, cfg: ModelConfig) -> Params:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def _positions(B: int, N: int, device) -> torch.Tensor:
    return torch.arange(N, dtype=torch.int32, device=device)[None].expand(B, N)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def forward_lm(params: Params, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, xcfg: ExchangeConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. batch: {"tokens": [B, N]} → (logits
    [B, N, V] f32, aux scalar)."""
    _require_dense(cfg)
    tokens = batch["tokens"]
    B, N = tokens.shape
    x = embed(params["embed"], tokens, scale_by_sqrt_d=cfg.embed_scale)
    positions = _positions(B, N, tokens.device)
    for lp in params["layers"]:
        x = _apply_attn_mlp(lp, x, cfg, xcfg, _attn_spec(cfg), positions)
    x = apply_norm(cfg.norm_type, params["final_norm"], x)
    logits = unembed(_head(params, cfg), x, final_softcap=cfg.final_softcap)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, seq: int,
                      device=None) -> Params:
    """Cache dict with a stacked leading layer dim (the JAX layout)."""
    _require_dense(cfg)
    c = init_kv_cache(batch, seq, cfg.n_kv_heads, cfg.hd, cfg.torch_dtype,
                      quant=cfg.kv_quant, device=device)
    return {"kv": {name: t[None].repeat(cfg.n_layers, *([1] * t.ndim))
                   for name, t in c.items()}}


def _layer_cache(cache: Params, i: int) -> Dict[str, torch.Tensor]:
    """Views of layer ``i``'s slice of the stacked cache (writes land in
    the stacked tensors)."""
    return {name: t[i] for name, t in cache["kv"].items()}


def decode_step(params: Params, batch: Dict[str, torch.Tensor], cache: Params,
                cache_index: int, cfg: ModelConfig, xcfg: ExchangeConfig
                ) -> Tuple[torch.Tensor, Params]:
    """One-token step. batch: {"tokens": [B, 1]} → (logits [B, 1, V],
    cache updated in place). ``cache_index`` is the write position."""
    _require_dense(cfg)
    x = embed(params["embed"], batch["tokens"],
              scale_by_sqrt_d=cfg.embed_scale)
    spec = _attn_spec(cfg)
    for i, lp in enumerate(params["layers"]):
        x = _apply_attn_mlp_decode(lp, x, cfg, xcfg, spec,
                                   _layer_cache(cache, i), cache_index)
    x = apply_norm(cfg.norm_type, params["final_norm"], x)
    logits = unembed(_head(params, cfg), x, final_softcap=cfg.final_softcap)
    return logits, cache


def supports_prefill(cfg: ModelConfig) -> bool:
    return cfg.family in PREFILL_FAMILIES


def prefill(params: Params, batch: Dict[str, torch.Tensor], cache: Params,
            cfg: ModelConfig, xcfg: ExchangeConfig
            ) -> Tuple[torch.Tensor, Params]:
    """Single-pass prefill: run the prompt [B, T0] through
    ``exchange_attention`` once and write the KV cache for positions
    [0, T0) → (last-position logits [B, 1, V] f32, primed cache)."""
    if not supports_prefill(cfg):
        raise ValueError(f"family {cfg.family!r} has no single-pass "
                         f"prefill; use the decode-loop prefill "
                         f"(repro_torch.api.generation.prefill_by_decode)")
    _require_dense(cfg)
    tokens = batch["tokens"]
    B, T0 = tokens.shape
    x = embed(params["embed"], tokens, scale_by_sqrt_d=cfg.embed_scale)
    positions = _positions(B, T0, tokens.device)
    spec = _attn_spec(cfg)
    for i, lp in enumerate(params["layers"]):
        x = _apply_attn_mlp_prefill(lp, x, cfg, xcfg, spec, positions,
                                    _layer_cache(cache, i))
    x = apply_norm(cfg.norm_type, params["final_norm"], x[:, -1:])
    logits = unembed(_head(params, cfg), x, final_softcap=cfg.final_softcap)
    return logits, cache
