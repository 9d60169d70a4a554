"""Segment-Means gradient compression for the slow (cross-pod) link.

Port of ``repro.train.grad_compress``: the cross-pod reduction exchanges
only L row-segment means per matrix (the same Eq. (1) operator used for
activations), shrinking its bytes by rows / L, with **error feedback**
(each pod keeps the residual ``g − decompress(compress(g))`` and adds it
to the next step's gradient before compressing, so all gradient mass is
eventually transmitted).

In the JAX package ``compressed_cross_pod_mean`` runs inside a
``shard_map`` over the pod axis and means with ``jax.lax.pmean``; here the
pod axis is a ``SeqGroup`` (one rank a pod), and the mean is one staged
``all_reduce`` of the payloads (booked as ``grad``) divided by the group's
size.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like


def compress(g: torch.Tensor, L: int) -> torch.Tensor:
    """Row-segment means of the leading dim: [r, ...] → [L, ...] (f32)."""
    r = g.shape[0]
    if L >= r or r % L:
        return g.float()
    seg = r // L
    return g.reshape(L, seg, *g.shape[1:]).float().mean(dim=1)


def decompress(z: torch.Tensor, r: int) -> torch.Tensor:
    """Broadcast L row means back to r rows (transpose of ``compress`` up to
    the 1/seg scale — each row receives its segment's mean)."""
    L = z.shape[0]
    if L >= r:
        return z
    return z.repeat_interleave(r // L, dim=0)


def compress_with_feedback(g: torch.Tensor, residual: Optional[torch.Tensor],
                           L: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gradient, carried residual) → (compressed payload, new residual).

    payload = compress(g + residual); new residual = (g + residual) −
    decompress(payload): exactly the mass the wire did NOT carry.
    """
    gf = g.float()
    if residual is not None:
        gf = gf + residual
    z = compress(gf, L)
    new_res = gf - decompress(z, g.shape[0]).float()
    return z, new_res


def compressed_cross_pod_mean(grads: Any, residuals: Any, L: int, group):
    """Mean-reduce a gradient tree across the ranks of ``group`` (one rank
    a pod) with Segment-Means payloads → (reduced grads, new residuals).

    Every leaf with a compressible leading dim sends ``L/r`` of its rows;
    the others are meaned whole (their residual passes through, zeros
    where there was none).  All payloads go in one staged ``all_reduce``.
    """
    flat_g = tree_leaves(grads)
    flat_r = (tree_leaves(residuals) if residuals is not None
              else [None] * len(flat_g))
    payload, new_res, keep = [], [], []
    for g, res in zip(flat_g, flat_r):
        if g.ndim < 2 or g.shape[0] % max(L, 1) or g.shape[0] <= L:
            payload.append(g.float())
            new_res.append(res)
            keep.append(False)
        else:
            z, nr = compress_with_feedback(g, res, L)
            payload.append(z)
            new_res.append(nr)
            keep.append(True)
    summed = group.all_reduce(payload, kind="grad")
    P = group.world_size
    out = [decompress(s / P, g.shape[0]) if comp else s / P
           for s, g, comp in zip(summed, flat_g, keep)]
    res_out = [torch.zeros_like(o) if r is None else r
               for o, r in zip(out, new_res)]
    return (tree_unflatten_like(grads, out),
            tree_unflatten_like(grads, res_out))


def init_residuals(grads: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compression_ratio(r: int, L: int) -> float:
    """Cross-pod byte reduction for a leading dim of r rows."""
    return r / L if (L < r and r % L == 0) else 1.0
