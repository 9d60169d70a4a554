"""PRISM attention op: builds the mean-bias vector from (part_idx, counts,
visibility) and runs the kernel.

Port of ``repro.kernels.prism_attention.ops``, with the semantics of
``repro_torch.core.prism_attention.prism_attention``.  The CUDA kernel
masks its ragged tiles itself, so the TPU's q-block padding is gone, it
takes ``kv_mask`` and ``q_offset``, and it reads the ``[B, P, L, Hk, dh]``
means as they are (strided views included), so nothing is copied.

The op is differentiable (``PrismAttention``, a
``torch.autograd.Function``): the forward is the kernel on a CUDA tensor
and the plain version on a CPU tensor, run without autograd; the backward
is one explicit PyTorch formula for both devices.  It recomputes the
probabilities over [local K ‖ means + bias] from the saved inputs (causal,
``q_offset``, ``kv_mask``, ``scale``, softcap, in f32) and gives dq,
dk_local, dv_local, dk_means and dv_means, each in its input's dtype; the
bias (and so the counts) and the mask get none.  A masked local score
passes no gradient (it is replaced by -1e30, as the plain version's
``where`` does); a mean's score always does (its bias is added).  The
JAX package has no backward kernel for PRISM attention (its Pallas kernel
is differentiated through its reference), so the port has none either: a
CUDA backward kernel is later work (ROADMAP queue 1b).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.prism_attention.kernel import prism_attention
from repro_torch.kernels.prism_attention.ref import NEG_INF


def _local_valid(B: int, Nq: int, Nk: int, *, causal: bool, q_offset: int,
                 kv_mask: Optional[torch.Tensor], device) -> Optional[
                     torch.Tensor]:
    """[B or 1, Nq, Nk] bool: the local keys a query may see, or None."""
    valid = None
    if causal:
        qpos = q_offset + torch.arange(Nq, device=device)[:, None]
        valid = (qpos >= torch.arange(Nk, device=device)[None, :])[None]
    if kv_mask is not None:
        m = kv_mask[:, None, :]
        valid = m if valid is None else valid & m
    return valid


class PrismAttention(torch.autograd.Function):
    """(q, k_loc, v_loc, k_means, v_means, mean_bias, kv_mask, causal,
    scale, softcap, q_offset, seen_means) → [B, Nq, H, dv] in q's dtype;
    the kernel (or the plain version on the CPU, the shape function on
    meta) forward, the explicit backward."""

    @staticmethod
    def forward(ctx, q, k, v, km, vm, bias, kv_mask, causal, scale, softcap,
                q_offset, seen_means=None):
        out = prism_attention(q, k, v, km, vm, bias, causal=causal,
                              scale=scale, softcap=softcap, kv_mask=kv_mask,
                              q_offset=q_offset, seen_means=seen_means)
        ctx.save_for_backward(q, k, v, km, vm, bias, kv_mask)
        ctx.opts = (causal, scale, softcap, q_offset)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, km, vm, bias, kv_mask = ctx.saved_tensors
        causal, scale, cap, q_offset = ctx.opts
        grads = prism_attention_grads(q, k, v, km, vm, bias, g,
                                      causal=causal, scale=scale,
                                      softcap=cap, kv_mask=kv_mask,
                                      q_offset=q_offset)
        return (*grads, None, None, None, None, None, None, None)


def prism_attention_grads(q, k, v, km, vm, bias, g, *, causal: bool,
                          scale: Optional[float], softcap: Optional[float],
                          kv_mask: Optional[torch.Tensor], q_offset: int):
    """The gradients of the PRISM attention output with cotangent ``g``
    → (dq, dk_loc, dv_loc, dk_means, dv_means), each in its input's shape
    and dtype (the means' as given: flat or ``[B, P, L, Hk, ·]``)."""
    B, Nq, H, dh = q.shape
    Nk, Hk, dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hk
    scl = (dh ** -0.5) if scale is None else scale
    kmf = km.reshape(B, -1, Hk, dh).float()
    vmf = vm.reshape(B, -1, Hk, dv).float()
    qg = q.float().reshape(B, Nq, Hk, G, dh)
    kf, vf = k.float(), v.float()
    s_loc = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scl
    s_m = torch.einsum("bqhgd,bkhd->bhgqk", qg, kmf) * scl
    if softcap is not None:
        t_loc, t_m = torch.tanh(s_loc / softcap), torch.tanh(s_m / softcap)
        s_loc, s_m = softcap * t_loc, softcap * t_m
    valid = _local_valid(B, Nq, Nk, causal=causal, q_offset=q_offset,
                         kv_mask=kv_mask, device=q.device)
    if valid is not None:
        valid = valid[:, None, None]                 # [B|1, 1, 1, Nq, Nk]
        s_loc = torch.where(valid, s_loc, NEG_INF)
    s_m = s_m + bias.float()[:, None, None, None, :]
    p = torch.softmax(torch.cat([s_loc, s_m], dim=-1), dim=-1)
    p_loc, p_m = p[..., :Nk], p[..., Nk:]
    dO = g.float().reshape(B, Nq, Hk, G, dv)
    dp_loc = torch.einsum("bqhgd,bkhd->bhgqk", dO, vf)
    dp_m = torch.einsum("bqhgd,bkhd->bhgqk", dO, vmf)
    rows = (p_loc * dp_loc).sum(-1, keepdim=True) + \
        (p_m * dp_m).sum(-1, keepdim=True)
    ds_loc = p_loc * (dp_loc - rows)
    ds_m = p_m * (dp_m - rows)
    if valid is not None:
        ds_loc = torch.where(valid, ds_loc, 0.0)
    if softcap is not None:
        ds_loc = ds_loc * (1 - t_loc * t_loc)
        ds_m = ds_m * (1 - t_m * t_m)
    ds_loc, ds_m = ds_loc * scl, ds_m * scl
    dq = (torch.einsum("bhgqk,bkhd->bqhgd", ds_loc, kf)
          + torch.einsum("bhgqk,bkhd->bqhgd", ds_m, kmf))
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds_loc, qg)
    dvl = torch.einsum("bhgqk,bqhgd->bkhd", p_loc, dO)
    dkm = torch.einsum("bhgqk,bqhgd->bkhd", ds_m, qg)
    dvm = torch.einsum("bhgqk,bqhgd->bkhd", p_m, dO)
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dvl.to(v.dtype),
            dkm.reshape(km.shape).to(km.dtype),
            dvm.reshape(vm.shape).to(vm.dtype))


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
    return PrismAttention.apply(
        q.contiguous(), k_loc.contiguous(), v_loc.contiguous(), k_means,
        v_means, bias,
        None if kv_mask is None else kv_mask.to(torch.bool).contiguous(),
        causal, scale, softcap, q_offset,
        (part_idx if causal else P - 1) * L)
