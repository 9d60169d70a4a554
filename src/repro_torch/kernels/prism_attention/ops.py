"""PRISM attention op: builds the mean-bias vector from (part_idx, counts,
visibility) and runs the kernel.

Port of ``repro.kernels.prism_attention.ops``, with the semantics of
``repro_torch.core.prism_attention.prism_attention``.  The CUDA kernel
masks its ragged tiles itself, so the TPU's q-block padding is gone, it
takes ``kv_mask`` and ``q_offset``, and it reads the ``[B, P, L, Hk, dh]``
means as they are (strided views included), so nothing is copied.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.prism_attention.kernel import prism_attention
from repro_torch.kernels.prism_attention.ref import NEG_INF


def build_mean_bias(B: int, P: int, L: int, part_idx: int, seg_size: int,
                    *, causal: bool,
                    mean_counts: Optional[torch.Tensor] = None,
                    device=None) -> torch.Tensor:
    """[B, P·L] f32 additive bias: log(count) for visible means, -1e30
    for the own partition, future partitions (causal) and empty
    segments."""
    if mean_counts is not None:
        device = mean_counts.device
    part_of_mean = torch.arange(P, device=device).repeat_interleave(L)
    visible = (part_of_mean < part_idx) if causal else (part_of_mean
                                                        != part_idx)
    if mean_counts is None:
        counts = torch.full((B, P * L), float(seg_size), dtype=torch.float32,
                            device=device)
        visible = visible[None, :]
    else:
        counts = mean_counts.reshape(B, P * L).float()
        visible = visible[None, :] & (counts > 0)
    bias = torch.log(torch.clamp(counts, min=1.0))
    return torch.where(visible, bias, NEG_INF).to(torch.float32)


def prism_attention_op(
    q: torch.Tensor,            # [B, Nq, H, dh]
    k_loc: torch.Tensor,        # [B, Nk, Hk, dh]
    v_loc: torch.Tensor,
    k_means: torch.Tensor,      # [B, P, L, Hk, dh]
    v_means: torch.Tensor,
    part_idx: int,
    seg_size: int,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
    mean_counts: Optional[torch.Tensor] = None,   # [B, P, L]
    kv_mask: Optional[torch.Tensor] = None,       # [B, Nk] bool
    q_offset: int = 0,
) -> torch.Tensor:
    B = q.shape[0]
    P, L = k_means.shape[1], k_means.shape[2]
    bias = build_mean_bias(B, P, L, part_idx, seg_size, causal=causal,
                           mean_counts=mean_counts, device=q.device)
    return prism_attention(
        q.contiguous(), k_loc.contiguous(), v_loc.contiguous(), k_means,
        v_means, bias,
        causal=causal, scale=scale, softcap=softcap,
        kv_mask=None if kv_mask is None else kv_mask.to(torch.bool)
        .contiguous(), q_offset=q_offset)
