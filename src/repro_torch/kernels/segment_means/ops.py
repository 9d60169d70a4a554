"""Segment-means op: the shape handling and the gradient around the kernel.

Port of ``repro.kernels.segment_means.ops``: trailing feature dims of a
``[B, N, ...feature]`` tensor are flattened into one, the kernel reduces
the token axis, and the feature shape is restored.  The CUDA kernel takes
any feature width, so the TPU's pad to a 128-lane multiple is gone.

Both ops are differentiable (``torch.autograd.Function``s): the forward is
the kernel on a CUDA tensor and the plain version on a CPU tensor, run
without autograd; the backward is explicit and the same on both devices.
A mean is linear in its segment's tokens, so each token receives its
segment's cotangent × mask / max(count, 1) (masked), or / (N / L)
(unmasked), in f32, cast to the input's dtype, as autograd of the plain
version computes it.  The counts get no gradient.  The JAX package has no
backward kernel for this op (its Pallas kernel is differentiated through
its reference), so neither has the port.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.segment_means.kernel import (segment_means,
                                                      segment_means_kv)


def _token_grad(g: torch.Tensor, N: int, mask: Optional[torch.Tensor],
                counts: torch.Tensor, dtype) -> torch.Tensor:
    """Cotangent of means ``[..., B, L, D]`` → of the tokens ``[..., B,
    N, D]``: each segment's cotangent over its tokens (masked out: 0),
    divided by the segment's count."""
    L = g.shape[-2]
    seg = N // L
    w = g.float() / torch.clamp(counts, min=1.0)[..., None]    # [.., B, L, D]
    out = w.repeat_interleave(seg, dim=-2)                     # [.., B, N, D]
    if mask is not None:
        out = out * mask.to(out.dtype)[..., None]
    return out.to(dtype)


class _SegmentMeans(torch.autograd.Function):
    """(x ``[B, N, D]``, mask or None) → (means ``[B, L, D]``, counts)."""

    @staticmethod
    def forward(ctx, x, mask, L):
        means, counts = segment_means(x, L, mask)
        ctx.save_for_backward(mask, counts)
        ctx.N, ctx.dtype = x.shape[1], x.dtype
        ctx.mark_non_differentiable(counts)
        return means, counts

    @staticmethod
    def backward(ctx, g, _):
        mask, counts = ctx.saved_tensors
        return _token_grad(g, ctx.N, mask, counts, ctx.dtype), None, None


class _SegmentMeansKV(torch.autograd.Function):
    """(k, v ``[B, N, D]``, mask or None) → (means ``[2, B, L, D]``,
    counts), one launch."""

    @staticmethod
    def forward(ctx, k, v, mask, L):
        means, counts = segment_means_kv(k, v, L, mask)
        ctx.save_for_backward(mask, counts)
        ctx.N, ctx.dtype = k.shape[1], k.dtype
        ctx.mark_non_differentiable(counts)
        return means, counts

    @staticmethod
    def backward(ctx, g, _):
        mask, counts = ctx.saved_tensors
        d = _token_grad(g, ctx.N, mask, counts, ctx.dtype)    # [2, B, N, D]
        return d[0], d[1], None, None


def segment_means_op(x: torch.Tensor, L: int,
                     mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment means over the token axis 1 of ``[B, N, ...feature]`` →
    (means ``[B, L, ...feature]``, counts ``[B, L]`` f32)."""
    B, N = x.shape[:2]
    feat = x.shape[2:]
    means, counts = _SegmentMeans.apply(
        x.reshape(B, N, -1).contiguous(),
        None if mask is None else mask.to(torch.bool).contiguous(), L)
    return means.reshape(B, L, *feat), counts


def segment_means_kv_op(k: torch.Tensor, v: torch.Tensor, L: int,
                        mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment means of K and V over the token axis 1 of
    ``[B, N, ...feature]``, one launch → (means ``[2, B, L,
    ...feature]``, counts ``[B, L]`` f32)."""
    B, N = k.shape[:2]
    feat = k.shape[2:]
    means, counts = _SegmentMeansKV.apply(
        k.reshape(B, N, -1).contiguous(), v.reshape(B, N, -1).contiguous(),
        None if mask is None else mask.to(torch.bool).contiguous(), L)
    return means.reshape(2, B, L, *feat), counts
