"""Segment Means compression (PRISM Eq. 1) and compression-rate math.

Port of ``repro.core.segment_means``.  Each sequence partition
``X_p ∈ R^{N_p×D}`` is divided into ``L`` equal, non-overlapping segments;
the column-wise mean of each segment forms the compact representation
``Z_p ∈ R^{L×D}`` exchanged between devices.

Compression rate: ``CR = N / (L · P)``.
"""
from __future__ import annotations

import torch


def segment_sizes(n_p: int, L: int) -> int:
    """Tokens per segment. Requires equal segments (paper keeps them integer)."""
    if L <= 0:
        raise ValueError(f"L must be positive, got {L}")
    if n_p % L != 0:
        raise ValueError(f"partition length {n_p} not divisible into {L} segments")
    return n_p // L


def segment_means(x: torch.Tensor, L: int, axis: int = -2) -> torch.Tensor:
    """Column-wise means of ``L`` equal segments along ``axis`` (Eq. 1),
    accumulated in f32 and cast back to ``x.dtype``."""
    axis = axis % x.ndim
    n_p = x.shape[axis]
    s = segment_sizes(n_p, L)
    new_shape = x.shape[:axis] + (L, s) + x.shape[axis + 1:]
    xr = x.reshape(new_shape)
    return xr.float().mean(dim=axis + 1).to(x.dtype)


def segment_means_masked(x: torch.Tensor, L: int, mask: torch.Tensor,
                         axis: int = -2):
    """Mask-aware segment means for padded sequences.

    ``mask`` is boolean over the segmented axis (its shape is x's up to and
    including ``axis``); padded positions are excluded from the mean.
    Returns ``(means, counts)`` where ``counts`` is the number of real
    tokens per segment.
    """
    axis = axis % x.ndim
    n_p = x.shape[axis]
    s = segment_sizes(n_p, L)
    new_shape = x.shape[:axis] + (L, s) + x.shape[axis + 1:]
    xr = x.reshape(new_shape).float()
    mshape = mask.shape[:axis] + (L, s)
    mr = mask.reshape(mshape).float()
    counts = mr.sum(dim=axis + 1)                          # [..., L]
    mexp = mr.reshape(mr.shape + (1,) * (xr.ndim - mr.ndim))
    total = (xr * mexp).sum(dim=axis + 1)
    means = total / torch.clamp(counts.reshape(
        counts.shape + (1,) * (total.ndim - counts.ndim)), min=1.0)
    return means.to(x.dtype), counts


def cr_to_L(n_tokens: int, P: int, cr: float) -> int:
    """Invert ``CR = N/(L·P)`` to the (integer) number of segment means."""
    L = int(round(n_tokens / (cr * P)))
    return max(L, 1)


def L_to_cr(n_tokens: int, P: int, L: int) -> float:
    return n_tokens / (L * P)


def comm_elements_voltage(P: int, N: int, D: int) -> int:
    """Per-device received elements for full-tensor exchange (Voltage)."""
    return (P - 1) * N * D // P


def comm_elements_prism(P: int, L: int, D: int) -> int:
    """Per-device received elements for Segment Means exchange (PRISM)."""
    return (P - 1) * L * D


def comm_reduction(P: int, N: int, L: int) -> float:
    """Communication speed-up factor of PRISM over Voltage (≈ CR)."""
    return comm_elements_voltage(P, N, 1) / max(comm_elements_prism(P, L, 1), 1)
