"""Flash-decode op: builds the validity bias from (cache_len, offset,
window), runs the partial-attention kernel, and merges shard partials (the
exact log-sum-exp combine used across devices)."""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_decode.kernel import flash_decode
from repro_torch.kernels.flash_decode.ref import NEG_INF


@functools.lru_cache(maxsize=None)
def pick_s_block(S: int) -> int:
    """Largest power-of-two tile (≤512) dividing ``S`` — the TPU kernel's
    S tile.  The CUDA kernel masks its ragged last tile instead and needs
    no divisor; this stays for callers that tile S themselves."""
    if S % 512 == 0:
        return 512
    return max(t for t in (256, 128, 64, 32, 16, 8, 4, 2, 1) if S % t == 0)


def validity_mask(B: int, S: int, cache_len, offset=0,
                  window: Optional[int] = None,
                  device=None) -> torch.Tensor:
    """[B, S] bool: True where the (global) position is a valid cache slot
    and inside the sliding window.  The one definition of cache validity —
    the kernel bias and the plain path both derive from it."""
    if isinstance(cache_len, torch.Tensor):
        device = cache_len.device if device is None else device
        clen = cache_len.to(device=device).reshape(-1, 1)
    else:
        clen = torch.as_tensor(cache_len, device=device).reshape(-1, 1)
    clen = clen.expand(B, 1)
    gpos = offset + torch.arange(S, device=clen.device)[None, :]
    ok = gpos < clen
    if window is not None:
        ok &= gpos >= clen - window
    return ok


def validity_bias(B: int, S: int, cache_len, offset=0,
                  window: Optional[int] = None, device=None) -> torch.Tensor:
    """[B, S] f32 additive bias: 0 where valid, -1e30 where empty / outside
    the sliding window."""
    ok = validity_mask(B, S, cache_len, offset=offset, window=window,
                       device=device)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def flash_decode_op(q: torch.Tensor,      # [B, 1, H, dh] or [B, H, dh]
                    k: torch.Tensor,      # [B, S, Hk, dh]
                    v: torch.Tensor,
                    cache_len,
                    *, offset=0, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    softcap: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial attention over the local cache → (o_unnorm, m, l): the CUDA
    kernel for CUDA tensors, its plain version for CPU tensors."""
    if q.ndim == 4:
        q = q[:, 0]
    B, H, dh = q.shape
    S = k.shape[1]
    bias = validity_bias(B, S, cache_len, offset=offset, window=window,
                         device=q.device)
    return flash_decode(q.contiguous(), k.contiguous(), v.contiguous(), bias,
                        scale=scale, softcap=softcap)


def merge_partials(o, m, l) -> torch.Tensor:
    """Combine [n_shards, B, H, dh] partials exactly (flash-decoding)."""
    m_star = m.amax(dim=0)                                   # [B, H]
    w = torch.exp(m - m_star[None])
    l_tot = (w * l).sum(dim=0)
    o_tot = (w[..., None] * o).sum(dim=0)
    return o_tot / l_tot[..., None]
