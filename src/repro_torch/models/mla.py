"""Multi-head Latent Attention (DeepSeek-V2) with PRISM latent exchange.

Port of ``repro.models.mla``.  The KV path is compressed to a rank-``r``
latent ``c_kv`` plus a shared rotary key ``k_pe``; only ``r + d_rope``
values a token are cached or exchanged.  PRISM's segment means are taken
in latent space (``repro_torch.core.exchange.exchange_attention_mla``),
and decode uses the absorbed form (W_uk folded into the query, W_uv
applied after attention), so the cache is never expanded.

Under a partitioned plan the decode cache is this rank's block of
positions, as the dense cache is (``layers.attention_decode``): the rank
owning a write position writes it, and attention merges every block's
partial softmax exactly (``exchange.mla_decode_attention_sharded``).

Under tensor parallelism over a mesh row (``tp``: the row's group,
``models.tp``) ``n_heads`` is the rank's share and ``w_uq``, ``w_uk``,
``w_uv`` and ``wo`` are its heads' blocks, and ``wo``'s partial products
are summed over the row.  Where M divides a latent's width (``tp.TPPlan.
latent``) the rank holds a column block of its projection (``w_dq``,
``w_dkv``), computes that block of the latent and gathers it over the row
(``gather_to``) before the norm, whose RMS spans the whole latent, and
before ``k_pe`` is split off: the gather's backward reduce-scatters the
cotangent, so each rank's projection gradient is its column block's, and
the norms' gradients are the rank's heads' parts, which the row sums.  A
latent M does not divide is computed whole on every rank and enters the
row's parallel region (``copy_to``: the backward sums its cotangent).
The latent cache is whole on every rank of the row.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import MLACfg
from repro_torch.core.exchange import (ExchangeConfig, exchange_attention_mla,
                                       mla_decode_attention_sharded,
                                       partitioned, seq_group_for)
from repro_torch.models.layers import (_write_at, apply_rope, dense_init,
                                       init_rmsnorm, rmsnorm, rope_tables)

Params = Dict[str, Any]


def init_mla(gen: torch.Generator, d: int, n_heads: int, cfg: MLACfg,
             dtype) -> Params:
    H, r, dev = n_heads, cfg.kv_lora_rank, gen.device

    def up(dim):                    # stored [r, H, dim]: mean, then expand
        w = torch.randn((r, H, dim), generator=gen, device=dev,
                        dtype=torch.float32)
        return (w * r ** -0.5).to(dtype)

    p = {"w_dq": dense_init(gen, d, cfg.q_lora_rank, dtype),
         "q_norm": init_rmsnorm(cfg.q_lora_rank, dev),
         "w_uq": dense_init(gen, cfg.q_lora_rank,
                            H * (cfg.qk_nope_dim + cfg.qk_rope_dim), dtype),
         "w_dkv": dense_init(gen, d, r + cfg.qk_rope_dim, dtype),
         "kv_norm": init_rmsnorm(r, dev),
         "w_uk": up(cfg.qk_nope_dim),
         "w_uv": up(cfg.v_head_dim)}
    p["wo"] = dense_init(gen, H * cfg.v_head_dim, d, dtype)
    return p


def _latents(params: Params, x: torch.Tensor, cfg: MLACfg,
             positions: torch.Tensor, theta: float, tp=None):
    """(the normed query latent, the normed KV latent, the rotary key) of
    ``x``, in the row's parallel region under ``tp``: a latent whose
    projection the rank holds a column block of is gathered over the row
    before its norm, a whole one enters as it is (``copy_to``)."""
    r = cfg.kv_lora_rank
    split_q = tp is not None and params["w_dq"].shape[-1] != cfg.q_lora_rank
    split_kv = tp is not None and \
        params["w_dkv"].shape[-1] != r + cfg.qk_rope_dim
    xs = tp.copy_to(x) if split_q or split_kv else x

    def project(w, split):
        return tp.gather_to(xs @ w) if split else x @ w
    c_q = rmsnorm(params["q_norm"], project(params["w_dq"], split_q))
    ckv = project(params["w_dkv"], split_kv)
    c_kv, k_pe = ckv[..., :r], ckv[..., r:]
    c_kv = rmsnorm(params["kv_norm"], c_kv)
    cos, sin = rope_tables(positions, cfg.qk_rope_dim, theta)
    k_pe = apply_rope(k_pe[..., None, :], cos, sin)[..., 0, :]
    if tp is not None and not split_q:
        c_q = tp.copy_to(c_q)
    if tp is not None and not split_kv:
        c_kv, k_pe = tp.copy_to(c_kv), tp.copy_to(k_pe)
    return c_q, c_kv, k_pe


def _project_q(params: Params, c_q: torch.Tensor, H: int, cfg: MLACfg,
               positions: torch.Tensor, theta: float) -> torch.Tensor:
    B, N, _ = c_q.shape
    q = (c_q @ params["w_uq"]).reshape(B, N, H,
                                       cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope, q_pe = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    cos, sin = rope_tables(positions, cfg.qk_rope_dim, theta)
    return torch.cat([q_nope, apply_rope(q_pe, cos, sin)], dim=-1)


def _output(params: Params, out: torch.Tensor, tp) -> torch.Tensor:
    """The heads [B, N, H, dv] through ``wo`` (under ``tp`` the rank's
    rows, summed over the row)."""
    B, N = out.shape[:2]
    y = out.reshape(B, N, -1) @ params["wo"]
    return y if tp is None else tp.reduce_from(y)


def _scale(cfg: MLACfg) -> float:
    return (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5


def _positions(x: torch.Tensor, positions):
    if positions is None:
        return torch.arange(x.shape[1], dtype=torch.int32,
                            device=x.device)[None, :]
    return positions


def mla_block(params: Params, x: torch.Tensor, n_heads: int, cfg: MLACfg,
              xcfg: ExchangeConfig, *,
              positions: Optional[torch.Tensor] = None,
              rope_theta: float = 10000.0, tp=None) -> torch.Tensor:
    """Full-sequence MLA attention (train / prefill).  Under a partitioned
    plan x is this rank's part of the sequence, at its global
    ``positions``."""
    positions = _positions(x, positions)
    c_q, c_kv, k_pe = _latents(params, x, cfg, positions, rope_theta, tp)
    q = _project_q(params, c_q, n_heads, cfg, positions, rope_theta)
    out = exchange_attention_mla(q, c_kv, k_pe, params["w_uk"],
                                 params["w_uv"], xcfg, causal=True,
                                 scale=_scale(cfg))
    return _output(params, out, tp)


def mla_prefill(params: Params, x: torch.Tensor, n_heads: int, cfg: MLACfg,
                xcfg: ExchangeConfig, cache: Dict[str, torch.Tensor], *,
                positions: Optional[torch.Tensor] = None,
                rope_theta: float = 10000.0, tp=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``mla_block`` that also writes the latent cache for the prompt's
    positions, in place.  In a seq group the rank fills its cache block
    from the latent the exchange gathered (VOLTAGE) or from a gather of
    its own (PRISM, booked as ``cache`` bytes)."""
    B, N, _ = x.shape
    positions = _positions(x, positions)
    c_q, c_kv, k_pe = _latents(params, x, cfg, positions, rope_theta, tp)
    q = _project_q(params, c_q, n_heads, cfg, positions, rope_theta)
    seen = []
    out = exchange_attention_mla(q, c_kv, k_pe, params["w_uk"],
                                 params["w_uv"], xcfg, causal=True,
                                 scale=_scale(cfg),
                                 latent_sink=seen.append)
    if not partitioned(xcfg):
        cache["c_kv"][:, :N] = c_kv.to(cache["c_kv"].dtype)
        cache["k_pe"][:, :N] = k_pe.to(cache["k_pe"].dtype)
    else:
        group = seq_group_for(xcfg)
        lat = seen[0] if seen else group.all_gather(
            torch.cat([c_kv, k_pe], dim=-1), kind="cache"
        ).permute(1, 0, 2, 3).reshape(B, -1, c_kv.shape[-1] + k_pe.shape[-1])
        Sp = cache["c_kv"].shape[1]
        lo = group.rank * Sp
        hi = min(lo + Sp, lat.shape[1])
        if hi > lo:
            r = c_kv.shape[-1]
            cache["c_kv"][:, :hi - lo] = lat[:, lo:hi, :r].to(
                cache["c_kv"].dtype)
            cache["k_pe"][:, :hi - lo] = lat[:, lo:hi, r:].to(
                cache["k_pe"].dtype)
    return _output(params, out, tp), cache


def mla_decode(params: Params, x: torch.Tensor, n_heads: int, cfg: MLACfg,
               xcfg: ExchangeConfig, cache: Dict[str, torch.Tensor],
               cache_index, *, rope_theta: float = 10000.0, tp=None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed-form decode over the latent cache, updated in place:

      logits_h = q_nope_h·W_uk_h·c_kvᵀ + q_pe·k_peᵀ ;  out_h = (p·c_kv)·W_uv_h

    ``cache_index`` is the global write position: an int for every row,
    or a ``[B]`` int tensor, one position (and one valid prefix) per row,
    written as ``layers.attention_decode`` writes a K/V cache.  Under
    ``tp`` the absorbed query and the attended latent are the rank's
    heads'."""
    B, H = x.shape[0], n_heads
    group = seq_group_for(xcfg) if partitioned(xcfg) else None
    per_row = isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1
    if per_row:
        idx = cache_index.to(device=x.device, dtype=torch.long)
        pos = idx[:, None]
    else:
        pos = torch.full((B, 1), cache_index, dtype=torch.int32,
                         device=x.device)
    c_q, c_new, pe_new = _latents(params, x, cfg, pos, rope_theta, tp)
    q = _project_q(params, c_q, H, cfg, pos, rope_theta)         # [B,1,H,dq]
    q_nope, q_pe = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    at, rows = _write_at(idx if per_row else cache_index,
                         cache["c_kv"].shape[1], group)
    if per_row:                  # one position per row: drop the token axis
        c_new, pe_new = c_new[:, 0][rows], pe_new[:, 0][rows]
    if at is not None:
        cache["c_kv"][at] = c_new.to(cache["c_kv"].dtype)
        cache["k_pe"][at] = pe_new.to(cache["k_pe"].dtype)

    # absorb: q_lat[b, 1, h, r] = q_nope · W_ukᵀ
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, params["w_uk"])
    cache_len = (idx + 1) if per_row else cache_index + 1
    o_lat = mla_decode_attention_sharded(q_lat, q_pe, cache["c_kv"],
                                         cache["k_pe"], cache_len, xcfg,
                                         scale=_scale(cfg))
    out = torch.einsum("bqhr,rhd->bqhd", o_lat, params["w_uv"])
    return _output(params, out, tp), cache


def init_mla_cache(batch: int, seq: int, cfg: MLACfg, dtype, device=None):
    return {"c_kv": torch.zeros((batch, seq, cfg.kv_lora_rank), dtype=dtype,
                                device=device),
            "k_pe": torch.zeros((batch, seq, cfg.qk_rope_dim), dtype=dtype,
                                device=device)}
