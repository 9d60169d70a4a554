"""Segment-means op: the shape handling around the kernel.

Port of ``repro.kernels.segment_means.ops``: trailing feature dims of a
``[B, N, ...feature]`` tensor are flattened into one, the kernel reduces
the token axis, and the feature shape is restored.  The CUDA kernel takes
any feature width, so the TPU's pad to a 128-lane multiple is gone.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.segment_means.kernel import segment_means


def segment_means_op(x: torch.Tensor, L: int,
                     mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment means over the token axis 1 of ``[B, N, ...feature]`` →
    (means ``[B, L, ...feature]``, counts ``[B, L]`` f32)."""
    B, N = x.shape[:2]
    feat = x.shape[2:]
    means, counts = segment_means(x.reshape(B, N, -1).contiguous(), L,
                                  None if mask is None
                                  else mask.to(torch.bool).contiguous())
    return means.reshape(B, L, *feat), counts
