"""Kernel-dispatch layer: route hot ops to the CUDA kernels or their plain
PyTorch versions, by the device of the tensors.

Port of ``repro.kernels.dispatch`` (``decode_attention`` so far).  The
route follows the data and nothing else: a CUDA tensor always goes to the
kernel, a CPU tensor to the plain version.  There is no override that
sends a CUDA tensor to the plain version.  ``backend_info()`` reports what
ran last.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_decode.kernel import flash_decode
from repro_torch.kernels.flash_decode.ops import flash_decode_op

_LAST = {"decode_attention": None}


def _route(t: torch.Tensor) -> str:
    return "cuda" if t.device.type == "cuda" else "reference"


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


def backend_info() -> dict:
    """What ran (benchmarks / docs / bug reports)."""
    return {"decode_attention": _LAST["decode_attention"],
            "flash_decode_launches": flash_decode.launches,
            "cuda_available": torch.cuda.is_available()}
