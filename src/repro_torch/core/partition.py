"""Position-wise partitioning (master–worker view) and single-host oracles.

Port of ``repro.core.partition``: the partitioning / reassembly math and
the single-host simulation of the P-device computation that the
``prism_sim`` plan runs on one device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.prism_attention import (prism_attention,
                                              reference_attention)
from repro_torch.core.segment_means import segment_means


def partition_sequence(x: torch.Tensor, P: int, axis: int = 1) -> torch.Tensor:
    """Split [..., N, ...] into [P, ..., N/P, ...] along ``axis``."""
    axis = axis % x.ndim
    N = x.shape[axis]
    if N % P != 0:
        raise ValueError(f"sequence length {N} not divisible by P={P}")
    return torch.stack(torch.chunk(x, P, dim=axis), dim=0)


def unpartition_sequence(parts: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`partition_sequence`: [P, ..., N/P, ...] → [..., N, ...]."""
    return torch.cat(list(parts.unbind(0)), dim=axis)


def simulate_prism_attention(
    q: torch.Tensor,   # [B, N, H, dh]  full-sequence projected queries
    k: torch.Tensor,   # [B, N, Hk, dh] full-sequence projected keys
    v: torch.Tensor,   # [B, N, Hk, dh]
    P: int,
    L: int,
    *,
    causal: bool = False,
    logit_softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-host oracle of the P-device PRISM attention: what every
    device p would produce (local full K/V + remote segment means,
    scaling-aware softmax), concatenated back into the full sequence.
    Needs N divisible by P·L."""
    B, N, H, dh = q.shape
    Np = N // P
    seg = Np // L
    qp = partition_sequence(q, P)     # [P, B, Np, H, dh]
    kp = partition_sequence(k, P)
    vp = partition_sequence(v, P)
    # [B, P, L, Hk, dh] — means of *projected* K/V (linearity: no re-projection)
    km_all = segment_means(kp, L, axis=2).transpose(0, 1)
    vm_all = segment_means(vp, L, axis=2).transpose(0, 1)
    outs = [prism_attention(qp[p], kp[p], vp[p], km_all, vm_all, p, seg,
                            causal=causal, logit_softcap=logit_softcap,
                            scale=scale)
            for p in range(P)]
    return torch.cat(outs, dim=1)


def simulate_voltage_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, P: int, *,
    causal: bool = False, logit_softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-host oracle of Voltage (full-tensor exchange): exactly full
    attention, walked partition by partition to mirror the distributed
    code."""
    B, N, H, dh = q.shape
    Np = N // P
    qp = partition_sequence(q, P)
    outs = [reference_attention(qp[p], k, v, causal=causal, q_offset=p * Np,
                                logit_softcap=logit_softcap, scale=scale)
            for p in range(P)]
    return torch.cat(outs, dim=1)
