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


def valid_positions(B: int, S: int, cache_len, offset=0,
                    window: Optional[int] = None) -> Optional[int]:
    """The cache positions that count over ``B`` rows of ``S`` slots from
    global position ``offset``, for an integer ``cache_len`` (a row with
    none counts all S, as the kernel reads them); None for a tensor."""
    if isinstance(cache_len, torch.Tensor):
        return None
    lo = offset if window is None else max(offset, cache_len - window)
    n = max(0, min(offset + S, cache_len) - lo)
    return B * (n or S)


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
                        scale=scale, softcap=softcap,
                        positions=valid_positions(B, S, cache_len, offset,
                                                  window))


def merge_partials(o, m, l) -> torch.Tensor:
    """Combine [n_shards, B, H, dh] partials exactly (flash-decoding):
    weights ``e^(m_i − m*)`` with ``m*`` the largest ``m``, summed in shard
    order, so every rank that merges the same partials holds bitwise the
    same output.  A shard with no valid position (m = -1e30, finite o and
    l) weighs exactly 0 while one shard is valid."""
    m_star = m.amax(dim=0)                                   # [B, H]
    o_tot = torch.zeros_like(o[0])
    l_tot = torch.zeros_like(l[0])
    for i in range(o.shape[0]):
        w = torch.exp(m[i] - m_star)
        o_tot = o_tot + w[..., None] * o[i]
        l_tot = l_tot + w * l[i]
    return o_tot / l_tot[..., None]
