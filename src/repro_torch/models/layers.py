"""Shared model building blocks (plain functions on tensors).

Port of ``repro.models.layers``.

Conventions
-----------
* Parameters are nested dicts of tensors, with the JAX package's layouts:
  weights are ``[d_in, d_out]`` and used as ``x @ W``.
* Weights are stored in ``cfg.dtype`` (bf16 by default); norms, softmax
  and RoPE compute in f32 and cast back to ``x.dtype``.
* Initializers draw from an explicit ``torch.Generator`` on the target
  device (the same distributions as the JAX package, not its numbers).
* Attention is the paper's integration point: ``ExchangeConfig`` decides
  how K/V cross sequence partitions — see ``repro_torch.core.exchange``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.exchange import (ExchangeConfig,
                                       decode_attention_sharded,
                                       exchange_attention)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = (d_in ** -0.5) if scale is None else scale
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype):
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, device=None) -> Params:
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with (1 + scale) weighting on a zero-centred scale
    (llama/gemma convention), in f32."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(x.dtype)


def init_layernorm(d: int, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def apply_norm(kind: str, params: Params, x: torch.Tensor) -> torch.Tensor:
    return layernorm(params, x) if kind == "layernorm" else rmsnorm(params, x)


def init_norm(kind: str, d: int, device=None) -> Params:
    return (init_layernorm(d, device) if kind == "layernorm"
            else init_rmsnorm(d, device))


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for integer positions [..., N] → ([..., N, hd/2], ...)
    f32 (split-half convention)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate [..., N, H, hd] by per-position tables [..., N, hd/2]: the
    first and second halves of each head are the rotated pair."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    c = cos[..., None, :]        # broadcast over heads
    s = sin[..., None, :]
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, d_ff: int, dtype,
             gated: bool = True) -> Params:
    p = {"w_up": dense_init(gen, d, d_ff, dtype),
         "w_down": dense_init(gen, d_ff, d, dtype)}
    if gated:
        p["w_gate"] = dense_init(gen, d, d_ff, dtype)
    return p


def apply_mlp(params: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    up = x @ params["w_up"]
    if "w_gate" in params:
        h = _act(x @ params["w_gate"], act) * up
    else:
        h = _act(up, act)
    return h @ params["w_down"]


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind in ("gelu", "gelu_tanh"):
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {kind}")


# ---------------------------------------------------------------------------
# GQA attention with the configured exchange
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, d: int, n_heads: int, n_kv: int,
                   head_dim: int, dtype, qkv_bias: bool = False) -> Params:
    p = {
        "wq": dense_init(gen, d, n_heads * head_dim, dtype),
        "wk": dense_init(gen, d, n_kv * head_dim, dtype),
        "wv": dense_init(gen, d, n_kv * head_dim, dtype),
        "wo": dense_init(gen, n_heads * head_dim, d, dtype),
    }
    if qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros((n_heads * head_dim,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((n_kv * head_dim,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((n_kv * head_dim,), dtype=dtype, device=dev)
    return p


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Static attention behaviour for one layer."""
    n_heads: int
    n_kv: int
    head_dim: int
    causal: bool = True
    window: Optional[int] = None          # sliding window
    logit_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    use_rope: bool = True
    scale: Optional[float] = None         # override 1/sqrt(hd)


def project_qkv(params: Params, x: torch.Tensor, spec: AttnSpec,
                positions: Optional[torch.Tensor]):
    """Linear projections + RoPE. x: [B, N, D] → q [B,N,H,hd], k/v [B,N,Hk,hd]."""
    B, N, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(B, N, spec.n_heads, spec.head_dim)
    k = k.reshape(B, N, spec.n_kv, spec.head_dim)
    v = v.reshape(B, N, spec.n_kv, spec.head_dim)
    if spec.use_rope:
        if positions is None:
            positions = torch.arange(N, dtype=torch.int32,
                                     device=x.device)[None, :]
        cos, sin = rope_tables(positions, spec.head_dim, spec.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def attention_block(params: Params, x: torch.Tensor, spec: AttnSpec,
                    xcfg: ExchangeConfig, *,
                    positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence (prefill) attention with the configured exchange."""
    q, k, v = project_qkv(params, x, spec, positions)
    out = exchange_attention(
        q, k, v, xcfg, causal=spec.causal, window=spec.window,
        logit_softcap=spec.logit_softcap, scale=spec.scale)
    B, N = x.shape[:2]
    return out.reshape(B, N, spec.n_heads * spec.head_dim) @ params["wo"]


def _quantize_kv(t: torch.Tensor):
    """Symmetric per-(token, head) int8 quantization: [B,N,Hk,dh] →
    (int8 values, f32 scale [B,N,Hk])."""
    tf = t.float()
    amax = tf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(tf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype):
    return (q.float() * scale[..., None]).to(dtype)


def attention_decode(
    params: Params,
    x: torch.Tensor,                      # [B, 1, D] new token features
    spec: AttnSpec,
    xcfg: ExchangeConfig,
    cache: Dict[str, torch.Tensor],       # {"k": [B,S,Hk,hd], "v": ..., }
    cache_index: int,                     # write position
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One autoregressive step against the layer's cache.

    The cache is updated in place (slice assignment) where the JAX package
    does a functional ``dynamic_update_slice``; the returned cache is the
    same dict.  Caches created with ``quant=True`` hold int8 values +
    per-(token, head) f32 scales, dequantized per layer for attention."""
    B = x.shape[0]
    pos = torch.full((B, 1), cache_index, dtype=torch.int32, device=x.device)
    q, k_new, v_new = project_qkv(params, x, spec, pos)
    i = cache_index
    if "k_scale" in cache:
        k_q, k_s = _quantize_kv(k_new)
        v_q, v_s = _quantize_kv(v_new)
        cache["k"][:, i:i + 1] = k_q
        cache["v"][:, i:i + 1] = v_q
        cache["k_scale"][:, i:i + 1] = k_s
        cache["v_scale"][:, i:i + 1] = v_s
        k_cache = _dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
        v_cache = _dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        cache["k"][:, i:i + 1] = k_new.to(cache["k"].dtype)
        cache["v"][:, i:i + 1] = v_new.to(cache["v"].dtype)
        k_cache, v_cache = cache["k"], cache["v"]
    cache_len = cache_index + 1
    if spec.window is not None:
        # sliding-window cache: only the last `window` positions are valid
        from repro_torch.kernels import dispatch as kdsp
        out = kdsp.decode_attention(q, k_cache, v_cache, cache_len,
                                    window=spec.window,
                                    logit_softcap=spec.logit_softcap,
                                    scale=spec.scale)
    else:
        out = decode_attention_sharded(
            q, k_cache, v_cache, cache_len, xcfg,
            logit_softcap=spec.logit_softcap, scale=spec.scale)
    y = out.reshape(B, 1, spec.n_heads * spec.head_dim) @ params["wo"]
    return y, cache


def prefill_kv_cache(cache: Dict[str, torch.Tensor], k_new: torch.Tensor,
                     v_new: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Write projected prompt K/V [B, T0, Hk, hd] into positions [0, T0)
    of a decode cache, in place.  Quantized caches get the same
    per-(token, head) int8 quantization the per-step path applies."""
    T0 = k_new.shape[1]
    if "k_scale" in cache:
        k_q, k_s = _quantize_kv(k_new)
        v_q, v_s = _quantize_kv(v_new)
        upd = {"k": k_q, "v": v_q, "k_scale": k_s, "v_scale": v_s}
    else:
        upd = {"k": k_new, "v": v_new}
    for name, val in upd.items():
        cache[name][:, :T0] = val.to(cache[name].dtype)
    return cache


def init_kv_cache(batch: int, seq: int, n_kv: int, head_dim: int, dtype,
                  quant: bool = False, device=None):
    shape = (batch, seq, n_kv, head_dim)
    if quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# embeddings / unembed
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype) -> Params:
    return {"table": embed_init(gen, vocab, d, dtype)}


def embed(params: Params, tokens: torch.Tensor, scale_by_sqrt_d: bool = False):
    x = params["table"][tokens]
    if scale_by_sqrt_d:
        x = x * torch.tensor(x.shape[-1] ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def unembed(params: Params, x: torch.Tensor,
            final_softcap: Optional[float] = None) -> torch.Tensor:
    """Tied unembedding: ``x @ table.T`` in the weights' dtype, then f32."""
    logits = (x @ params["table"].T).float()
    if final_softcap is not None:
        logits = final_softcap * torch.tanh(logits / final_softcap)
    return logits
