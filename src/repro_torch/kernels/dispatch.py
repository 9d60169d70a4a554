"""Kernel-dispatch layer: route hot ops to the CUDA kernels or their plain
PyTorch versions, by the device of the tensors.

Port of ``repro.kernels.dispatch`` (``segment_means``,
``segment_means_masked``, ``decode_attention``, ``decode_attention_paged``
and ``prism_attention``).
The route follows the data and nothing else: a CUDA tensor always goes to
the kernel, a CPU tensor to the plain version.  There is no override that
sends a CUDA tensor to the plain version, and no argument the JAX package
sends to its reference (a segment axis other than 1, masked local keys in
PRISM attention) leaves the kernel.  ``backend_info()`` reports what ran
last and each kernel's launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_decode.kernel import flash_decode
from repro_torch.kernels.flash_decode.ops import flash_decode_op
from repro_torch.kernels.flash_decode.paged import (flash_decode_paged,
                                                    flash_decode_paged_op)
from repro_torch.kernels.prism_attention.kernel import \
    prism_attention as prism_attention_kernel
from repro_torch.kernels.prism_attention.ops import prism_attention_op
from repro_torch.kernels.segment_means.kernel import \
    segment_means as segment_means_kernel
from repro_torch.kernels.segment_means.ops import segment_means_op

_LAST = {"segment_means": None, "decode_attention": None,
         "decode_attention_paged": None, "prism_attention": None}


def _route(t: torch.Tensor) -> str:
    return "cuda" if t.device.type == "cuda" else "reference"


# ---------------------------------------------------------------------------
# Segment Means (PRISM Eq. 1) — compression hot path
# ---------------------------------------------------------------------------

def _lead(x: torch.Tensor, axis: int) -> torch.Tensor:
    """x viewed as [prod(x.shape[:axis]), N, ...]: the segment axis at 1."""
    return x.reshape(-1, *x.shape[axis:])


def segment_means_masked(x: torch.Tensor, L: int, mask: torch.Tensor,
                         axis: int = -2
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask-aware means of L equal segments along ``axis`` → (means,
    counts ``x.shape[:axis] + (L,)`` f32); ``mask`` has x's shape up to
    and including ``axis``; padded tokens are left out of each mean."""
    axis = axis % x.ndim
    _LAST["segment_means"] = _route(x)
    xs = _lead(x, axis)
    means, counts = segment_means_op(xs, L, mask.reshape(xs.shape[:2]))
    return (means.reshape(*x.shape[:axis], L, *x.shape[axis + 1:]),
            counts.reshape(*x.shape[:axis], L))


def segment_means(x: torch.Tensor, L: int, axis: int = -2) -> torch.Tensor:
    """Column-wise means of L equal segments along ``axis`` (Eq. 1), in
    x's dtype."""
    axis = axis % x.ndim
    _LAST["segment_means"] = _route(x)
    means, _ = segment_means_op(_lead(x, axis), L)
    return means.reshape(*x.shape[:axis], L, *x.shape[axis + 1:])


# ---------------------------------------------------------------------------
# One-token decode attention — the generation hot path
# ---------------------------------------------------------------------------

def decode_attention(q: torch.Tensor,        # [B, 1, H, dh]
                     k_cache: torch.Tensor,  # [B, S, Hk, dh]
                     v_cache: torch.Tensor,
                     cache_len,              # [B] or scalar — valid prefix
                     *,
                     offset: int = 0,
                     window: Optional[int] = None,
                     logit_softcap: Optional[float] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention against a device-local KV cache, masked to
    the valid ``cache_len`` prefix (optionally sliding-``window``-limited):
    the flash-decode (o·l, m, l) partials, normalized locally (the
    single-shard case of the cross-shard LSE merge)."""
    _LAST["decode_attention"] = _route(q)
    o, m, l = flash_decode_op(q, k_cache, v_cache, cache_len, offset=offset,
                              window=window, scale=scale,
                              softcap=logit_softcap)
    out = o / torch.clamp(l, min=1e-38)[..., None]            # [B, H, dh]
    return out[:, None].to(q.dtype)                           # [B,1,H,dh]


def decode_attention_paged(q: torch.Tensor,           # [B, 1, H, dh]
                           k_pool: torch.Tensor,      # [P, ps, Hk, dh]
                           v_pool: torch.Tensor,
                           page_table: torch.Tensor,  # [B, max_pages] int
                           cache_len,                 # [B] — valid prefix
                           *,
                           logit_softcap: Optional[float] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Single-token attention against a *paged* KV pool: each request's
    cache is the concatenation of the pool pages named by its page-table
    row, masked to the valid ``cache_len`` prefix.  The paged flash-decode
    kernel on a CUDA tensor (pages resolved in-kernel, no gather), its
    plain version (gather + dense math) on a CPU tensor."""
    _LAST["decode_attention_paged"] = _route(q)
    o, m, l = flash_decode_paged_op(q, k_pool, v_pool, page_table,
                                    cache_len, scale=scale,
                                    softcap=logit_softcap)
    out = o / torch.clamp(l, min=1e-38)[..., None]            # [B, H, dh]
    return out[:, None].to(q.dtype)                           # [B,1,H,dh]


# ---------------------------------------------------------------------------
# PRISM prefill attention (scaling-aware softmax over local ‖ remote means)
# ---------------------------------------------------------------------------

def prism_attention(q, k_local, v_local, k_means, v_means, part_idx: int,
                    seg_size: int, *, causal: bool = False,
                    logit_softcap: Optional[float] = None,
                    scale: Optional[float] = None,
                    kv_mask: Optional[torch.Tensor] = None,
                    mean_counts: Optional[torch.Tensor] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Scaling-aware softmax attention (see
    ``repro_torch.core.prism_attention``): q [B, Np, H, dh] over the local
    K/V and the means [B, P, L, Hk, dh] of every partition, the own one
    hidden."""
    _LAST["prism_attention"] = _route(q)
    return prism_attention_op(q, k_local, v_local, k_means, v_means,
                              part_idx, seg_size, causal=causal, scale=scale,
                              softcap=logit_softcap, mean_counts=mean_counts,
                              kv_mask=kv_mask, q_offset=q_offset)


def backend_info() -> dict:
    """What ran (benchmarks / docs / bug reports)."""
    return {**_LAST,
            "segment_means_launches": segment_means_kernel.launches,
            "flash_decode_launches": flash_decode.launches,
            "flash_decode_paged_launches": flash_decode_paged.launches,
            "prism_attention_launches": prism_attention_kernel.launches,
            "cuda_available": torch.cuda.is_available()}
