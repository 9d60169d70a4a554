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
* Tensor parallelism over a mesh row (``repro_torch.models.tp``): an
  ``AttnSpec`` with ``tp`` names the rank's heads (their count and first
  index), and ``apply_mlp``,
  ``embed`` and ``unembed`` take the row's group as ``tp``; the weights
  they are given are then the rank's blocks, and every output but
  ``unembed``'s (the rank's vocab columns) is the whole, the same on every
  rank of the row.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.exchange import (ExchangeConfig,
                                       decode_attention_sharded,
                                       exchange_attention, partitioned,
                                       seq_group_for)

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


def apply_mlp(params: Params, x: torch.Tensor, act: str = "silu",
              tp=None) -> torch.Tensor:
    """The MLP; with ``tp`` (the row's group) its rank's columns of
    ``w_up``/``w_gate`` and rows of ``w_down``, the partial products summed
    over the row."""
    if tp is not None:
        x = tp.copy_to(x)
    up = x @ params["w_up"]
    if "w_gate" in params:
        h = _act(x @ params["w_gate"], act) * up
    else:
        h = _act(up, act)
    y = h @ params["w_down"]
    return y if tp is None else tp.reduce_from(y)


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
    tp: Any = None                        # the row's SeqGroup when the heads
                                          # above are the rank's share
    q0: int = 0                           # the rank's first query head
    kv0: int = 0                          # and first KV head
    kv_shared: bool = False               # wk/wv whole: slice the KV head


def kv_weights(params: Params, spec: AttnSpec):
    """``wk``, ``wv`` as the rank computes with them: held whole where
    its KV head is shared with other ranks of the row, and sliced to it."""
    wk, wv = params["wk"], params["wv"]
    if spec.kv_shared:
        cols = slice(spec.kv0 * spec.head_dim,
                     (spec.kv0 + spec.n_kv) * spec.head_dim)
        wk, wv = wk[:, cols], wv[:, cols]
    return wk, wv


def project_qkv(params: Params, x: torch.Tensor, spec: AttnSpec,
                positions: Optional[torch.Tensor]):
    """Linear projections + RoPE. x: [B, N, D] → q [B,N,H,hd], k/v [B,N,Hk,hd].
    Under ``spec.tp`` the weights are the rank's columns (``kv_weights``),
    the biases (whole) are sliced to its heads, and x enters the row's
    parallel region."""
    B, N, _ = x.shape
    if spec.tp is not None:
        x = spec.tp.copy_to(x)
    wk, wv = kv_weights(params, spec)
    q = x @ params["wq"]
    k = x @ wk
    v = x @ wv
    if "bq" in params:
        hd = spec.head_dim
        qs = slice(spec.q0 * hd, (spec.q0 + spec.n_heads) * hd)
        ks = slice(spec.kv0 * hd, (spec.kv0 + spec.n_kv) * hd)
        q = q + params["bq"][qs]
        k = k + params["bk"][ks]
        v = v + params["bv"][ks]
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
    return attention_output(params, out, spec)


def attention_output(params: Params, heads: torch.Tensor,
                     spec: AttnSpec) -> torch.Tensor:
    """The heads [B, N, H, hd] through ``wo`` → [B, N, D]; under
    ``spec.tp`` the rank's rows of ``wo``, summed over the row."""
    B, N = heads.shape[:2]
    y = heads.reshape(B, N, spec.n_heads * spec.head_dim) @ params["wo"]
    return y if spec.tp is None else spec.tp.reduce_from(y)


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


def _write_at(index, Sp: int, group):
    """Where one decode step writes in a cache (block) of ``Sp`` positions
    → (index for the cache leaves or None, the rows of the new K/V that
    land there).  ``index`` is an int or a ``[B]`` long tensor of global
    positions.  With one partition every row writes: a per-row position
    past the end lands on the last one.  Rank p of a group writes the
    positions in ``[p·Sp, (p+1)·Sp)`` of the ``P·Sp`` cache at
    ``index − p·Sp`` (per row: clamped to ``P·Sp − 1`` first)."""
    if group is None:
        if isinstance(index, torch.Tensor):
            rows = torch.arange(index.shape[0], device=index.device)
            return (rows, index.clamp(max=Sp - 1)), slice(None)
        return (slice(None), slice(index, index + 1)), slice(None)
    off = group.rank * Sp
    if isinstance(index, torch.Tensor):
        w = index.clamp(max=Sp * group.world_size - 1) - off
        rows = ((w >= 0) & (w < Sp)).nonzero()[:, 0]
        return (rows, w[rows]), rows
    i = index - off
    return ((slice(None), slice(i, i + 1)) if 0 <= i < Sp else None,
            slice(None))


def attention_decode(
    params: Params,
    x: torch.Tensor,                      # [B, 1, D] new token features
    spec: AttnSpec,
    xcfg: ExchangeConfig,
    cache: Dict[str, torch.Tensor],       # {"k": [B,S,Hk,hd], "v": ..., }
    cache_index,                          # int, or [B] int tensor
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One autoregressive step against the layer's cache.

    The cache is updated in place (slice assignment) where the JAX package
    does a functional ``dynamic_update_slice``; the returned cache is the
    same dict.  Caches created with ``quant=True`` hold int8 values +
    per-(token, head) f32 scales, dequantized per layer for attention.

    ``cache_index`` is the global write position: one int for every row,
    or a ``[B]`` int tensor giving each row its own position (the slot
    pool of ``repro_torch.serving``, one batched step where the JAX package
    vmaps ``decode_step`` per slot).  Then row ``b`` takes RoPE at
    ``cache_index[b]``, attends over its first ``cache_index[b] + 1``
    positions and writes at ``min(cache_index[b], S - 1)``: a write past
    the end lands on the last position, as JAX's ``dynamic_update_slice``
    clamps it (a finished slot that keeps decoding at ``max_len``).

    Under a partitioned plan ``cache`` is this rank's block of ``Sp``
    positions, ``[p·Sp, (p+1)·Sp)`` of a cache of ``P·Sp``: the rank that
    owns a write position writes there (at ``index − p·Sp``), the others
    write nothing, and attention merges every rank's block
    (``exchange.decode_attention_sharded``; a sliding-window layer's
    blocks under the window, where the JAX package attends its
    mesh-sharded cache under the window in one call)."""
    B = x.shape[0]
    group = seq_group_for(xcfg) if partitioned(xcfg) else None
    per_row = isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1
    if per_row:
        idx = cache_index.to(device=x.device, dtype=torch.long)
        pos = idx[:, None]
    else:
        pos = torch.full((B, 1), cache_index, dtype=torch.int32,
                         device=x.device)
    at, rows = _write_at(idx if per_row else cache_index, cache["k"].shape[1],
                         group)
    q, k_new, v_new = project_qkv(params, x, spec, pos)
    if per_row:                  # one position per row: drop the token axis
        k_new, v_new = k_new[:, 0][rows], v_new[:, 0][rows]
    if "k_scale" in cache:
        k_q, k_s = _quantize_kv(k_new)
        v_q, v_s = _quantize_kv(v_new)
        if at is not None:
            cache["k"][at] = k_q
            cache["v"][at] = v_q
            cache["k_scale"][at] = k_s
            cache["v_scale"][at] = v_s
        k_cache = _dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
        v_cache = _dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        if at is not None:
            cache["k"][at] = k_new.to(cache["k"].dtype)
            cache["v"][at] = v_new.to(cache["v"].dtype)
        k_cache, v_cache = cache["k"], cache["v"]
    cache_len = (idx + 1) if per_row else cache_index + 1
    # a sliding-window layer sees only the last `window` positions: with
    # one partition straight onto the flash-decode kernel, across a seq
    # group each block's windowed partial and the exact merge
    out = decode_attention_sharded(
        q, k_cache, v_cache, cache_len, xcfg,
        logit_softcap=spec.logit_softcap, scale=spec.scale,
        window=spec.window)
    return attention_output(params, out, spec), cache


def attention_decode_paged(
    params: Params,
    x: torch.Tensor,                      # [S, 1, D] new token features
    spec: AttnSpec,
    xcfg: ExchangeConfig,
    cache: Dict[str, torch.Tensor],       # {"k": [P,ps,Hk,hd], "v": ...}
    page_table: torch.Tensor,             # [S, max_pages] int32
    lengths: torch.Tensor,                # [S] int — per-row write position
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One autoregressive step against a shared *paged* KV pool.

    All rows step together: the pool is shared state.  Row ``b`` writes its
    new K/V at logical position ``lengths[b]``, which the page table
    resolves to physical ``(page_table[b, len // ps], len % ps)``; attention
    then reads through ``kdsp.decode_attention_paged``.  The write is an
    in-place ``index_put_`` into the pool, where the JAX package's
    ``.at[].set`` builds a new pool that XLA updates in place only because
    the caller donates it; the returned cache is the same dict.  Rows never
    write into shared (refcount > 1) pages: the allocator copies any
    partially filled shared page at admission, so a row's write frontier
    lands in a page it owns alone (or the trash page, for idle rows)."""
    if spec.window is not None:
        raise NotImplementedError("paged decode has no sliding-window path")
    B = x.shape[0]
    lens = lengths.to(device=x.device, dtype=torch.long)
    q, k_new, v_new = project_qkv(params, x, spec, lens[:, None])
    ps = cache["k"].shape[1]
    table = page_table.to(device=x.device)
    wp = table.gather(1, (lens // ps)[:, None])[:, 0].long()   # [S]
    off = lens % ps
    cache["k"].index_put_((wp, off), k_new[:, 0].to(cache["k"].dtype))
    cache["v"].index_put_((wp, off), v_new[:, 0].to(cache["v"].dtype))
    from repro_torch.kernels import dispatch as kdsp
    out = kdsp.decode_attention_paged(
        q, cache["k"], cache["v"], table, lens + 1,
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


def embed(params: Params, tokens: torch.Tensor, scale_by_sqrt_d: bool = False,
          tp=None):
    """The table's rows of ``tokens``; with ``tp`` (the row's group) the
    table is the rank's block of V/M rows: the ids outside it look up row
    0 and are zeroed, and the row sums the ranks' lookups."""
    if tp is None:
        x = params["table"][tokens]
    else:
        n = params["table"].shape[0]
        local = tokens.long() - tp.rank * n
        mine = (local >= 0) & (local < n)
        x = params["table"][torch.where(mine, local, 0)]
        x = tp.reduce_from(x * mine[..., None].to(x.dtype))
    if scale_by_sqrt_d:
        x = x * torch.tensor(x.shape[-1] ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def unembed(params: Params, x: torch.Tensor,
            final_softcap: Optional[float] = None, tp=None) -> torch.Tensor:
    """Tied unembedding: ``x @ table.T`` in the weights' dtype, then f32.
    With ``tp`` the table is the rank's block of V/M rows and the logits
    its V/M columns (softcapped elementwise: the same values as the
    whole's); ``tp.gather_from`` joins them."""
    if tp is not None:
        x = tp.copy_to(x)
    logits = (x @ params["table"].T).float()
    if final_softcap is not None:
        logits = final_softcap * torch.tanh(logits / final_softcap)
    return logits
