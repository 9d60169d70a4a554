"""Plain PyTorch version of the flash-decode partial-attention kernel.

The CPU path of ``flash_decode`` and the oracle the CUDA kernel is held
against on the card (same f32 arithmetic from the same inputs).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def flash_decode_ref(q: torch.Tensor,        # [B, H, dh]
                     k: torch.Tensor,        # [B, S, Hk, dh]
                     v: torch.Tensor,
                     kv_bias: torch.Tensor,  # [B, S] additive (0 / -1e30)
                     *, scale: Optional[float] = None,
                     softcap: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial attention over the local cache → (o·l, m, l), all f32:
    un-normalized weighted values plus the softmax stats, so shards merge
    exactly: o = Σ e^{m_i - m*} o_i / Σ e^{m_i - m*} l_i."""
    B, H, dh = q.shape
    Hk = k.shape[2]
    scale = (dh ** -0.5) if scale is None else scale
    kf = k.float()
    vf = v.float()
    if Hk != H:                # query head h reads KV head h // (H / Hk)
        B, S = k.shape[:2]
        kf = kf[:, :, :, None].expand(B, S, Hk, H // Hk, dh).reshape(B, S, H, dh)
        vf = vf[:, :, :, None].expand(B, S, Hk, H // Hk, dh).reshape(B, S, H, dh)
    s = torch.einsum("bhd,bshd->bhs", q.float() * scale, kf)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = s + kv_bias.float()[:, None, :]
    m = s.amax(dim=-1)                                       # [B, H]
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)                                        # [B, H]
    o = torch.einsum("bhs,bshd->bhd", p, vf)                 # un-normalized
    return o, m, l
