"""Plain PyTorch version of the segment-means kernel.

The CPU path of ``segment_means`` and the oracle the CUDA kernel is held
against on the card (the same f32 sums from the same inputs).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def segment_means_ref(x: torch.Tensor,                 # [B, N, D]
                      L: int,
                      mask: Optional[torch.Tensor] = None  # [B, N] bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Means of L equal token segments → (means [B, L, D] in x's dtype,
    counts [B, L] f32).  With a mask, padded tokens are left out of each
    mean and ``counts`` holds the real tokens per segment (an empty segment
    gives a zero mean); without one every segment counts N / L tokens."""
    B, N, D = x.shape
    seg = N // L
    xr = x.reshape(B, L, seg, D).float()
    if mask is None:
        counts = torch.full((B, L), float(seg), dtype=torch.float32,
                            device=x.device)
        return xr.mean(dim=2).to(x.dtype), counts
    mr = mask.reshape(B, L, seg).float()
    counts = mr.sum(dim=2)
    total = (xr * mr[..., None]).sum(dim=2)
    means = total / torch.clamp(counts, min=1.0)[..., None]
    return means.to(x.dtype), counts
