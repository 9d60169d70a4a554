"""Scaling-aware softmax attention over Segment-Means-augmented keys (PRISM).

Port of ``repro.core.prism_attention`` (the plain-tensor semantics):

  * Queries come from the local partition ``X_p``.
  * Keys/Values are the local partition's full K/V **plus** the Segment
    Means of every other partition (Eq. 2).  Projections are linear, so
    devices exchange *projected* segment means and never re-project remote
    features.
  * Scaling-aware softmax: a mean key standing in for a segment of ``s``
    real keys receives an additive logit bias ``log(s)`` so that
    ``s·exp(q·k̄) ≈ Σ_{i∈seg} exp(q·k_i)``.

Causal extension: a segment mean is visible to a query iff its partition
index is strictly less than the query's.  Masked logits take ``NEG_INF =
-1e30`` (never ``-inf``), so a fully masked row softmaxes to a uniform row
instead of NaN — exactly as the JAX package does.

Layouts follow the JAX package: q ``[B, N, H, dh]``, k/v ``[B, N, Hk, dh]``.
Scores and probabilities are f32; the output is cast back to ``q.dtype``.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def _expand_kv(kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Broadcast grouped KV heads [..., Hk, d] to query heads [..., H, d]:
    query head ``h`` reads KV head ``h // (H / Hk)``."""
    hk = kv.shape[-2]
    if hk == n_heads:
        return kv
    assert n_heads % hk == 0, f"GQA heads {n_heads} not a multiple of {hk}"
    return torch.repeat_interleave(kv, n_heads // hk, dim=-2)


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B,Nq,H,dh] · k [B,Nk,Hk,dh] → [B,H,Nq,Nk] f32, without
    materializing the GQA head repeat (f32 accumulation)."""
    B, Nq, H, dh = q.shape
    Hk = k.shape[2]
    qf, kf = q.float(), k.float()
    if Hk == H:
        return torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    g = H // Hk
    qg = qf.reshape(B, Nq, Hk, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf)
    return s.reshape(B, H, Nq, k.shape[1])


def _grouped_values(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p [B,H,Nq,Nk] f32 · v [B,Nk,Hk,dh] → [B,Nq,H,dh] f32 (grouped)."""
    B, H, Nq, Nk = p.shape
    Hk, dh = v.shape[2], v.shape[3]
    vf = v.float()
    if Hk == H:
        return torch.einsum("bhqk,bkhd->bqhd", p, vf)
    g = H // Hk
    pg = p.reshape(B, Hk, g, Nq, Nk)
    o = torch.einsum("bhgqk,bkhd->bqhgd", pg, vf)
    return o.reshape(B, Nq, H, dh)


def reference_attention(
    q: torch.Tensor,               # [B, Nq, H, dh]
    k: torch.Tensor,               # [B, Nk, Hk, dh]
    v: torch.Tensor,               # [B, Nk, Hk, dh]
    *,
    causal: bool = False,
    q_offset: int = 0,             # global position of q[0]
    kv_offset: int = 0,            # global position of k[0]
    window: Optional[int] = None,  # sliding-window size
    logit_softcap: Optional[float] = None,
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,     # [..., Nq, Nk] additive bias
    kv_mask: Optional[torch.Tensor] = None,  # [B, Nk] bool; False → masked
) -> torch.Tensor:
    """Plain full attention — the oracle for every optimized path."""
    B, Nq, H, dh = q.shape
    Nk = k.shape[1]
    scale = (dh ** -0.5) if scale is None else scale
    logits = _grouped_scores(q, k) * scale
    logits = _softcap(logits, logit_softcap)
    if bias is not None:
        logits = logits + bias
    dev = q.device
    qpos = q_offset + torch.arange(Nq, device=dev)[:, None]
    kpos = kv_offset + torch.arange(Nk, device=dev)[None, :]
    mask = torch.ones((Nq, Nk), dtype=torch.bool, device=dev)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    logits = torch.where(mask[None, None], logits, NEG_INF)
    if kv_mask is not None:
        logits = torch.where(kv_mask[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = _grouped_values(p, v)
    return out.to(q.dtype)


def chunked_reference_attention(
    q: torch.Tensor,               # [B, Nq, H, dh]
    k: torch.Tensor,               # [B, Nk, Hk, dh]
    v: torch.Tensor,
    *,
    chunk: Optional[int] = None,
    causal: bool = False,
    q_offset: int = 0,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    scale: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,
    target_bytes: float = 0.5e9,
) -> torch.Tensor:
    """``reference_attention`` evaluated in query chunks (a Python loop in
    place of ``lax.map``), bounding the live f32 score block to
    [B, H, chunk, Nk] under ``target_bytes``.  Same math as the unchunked
    oracle."""
    B, Nq, H, dh = q.shape
    if chunk is None:
        per_row = B * H * k.shape[1] * 4.0
        chunk = max(int(target_bytes / max(per_row, 1.0)), 16)
        chunk = 1 << (chunk.bit_length() - 1)          # floor pow2
    C = min(chunk, Nq)
    if Nq % C:
        return reference_attention(q, k, v, causal=causal, q_offset=q_offset,
                                   window=window, logit_softcap=logit_softcap,
                                   scale=scale, kv_mask=kv_mask)
    outs = [reference_attention(q[:, i:i + C], k, v, causal=causal,
                                q_offset=q_offset + i, window=window,
                                logit_softcap=logit_softcap, scale=scale,
                                kv_mask=kv_mask)
            for i in range(0, Nq, C)]
    return torch.cat(outs, dim=1)


def prism_attention(
    q: torch.Tensor,        # [B, Np, H, dh]   local queries (partition p)
    k_local: torch.Tensor,  # [B, Np, Hk, dh]  local full keys
    v_local: torch.Tensor,  # [B, Np, Hk, dh]
    k_means: torch.Tensor,  # [B, P, L, Hk, dh] segment-mean keys, ALL partitions
    v_means: torch.Tensor,  # [B, P, L, Hk, dh]
    part_idx: int,          # this device's partition index p
    seg_size: int,          # tokens represented by each segment mean
    *,
    causal: bool = False,
    logit_softcap: Optional[float] = None,
    scale: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,      # [B, Np] bool; False → pad
    mean_counts: Optional[torch.Tensor] = None,  # [B, P, L] real tokens/mean
    q_offset: int = 0,                           # local offset (chunking)
) -> torch.Tensor:
    """Scaling-aware softmax attention over [local full ‖ remote means].

    ``k_means[:, p]`` (own partition) is always masked out.  Under
    ``causal=True`` only partitions strictly before ``part_idx`` contribute
    their means.  Padded sequences pass ``kv_mask`` and ``mean_counts``
    (the bias becomes ``log(count)`` and empty segments are dropped).  Long
    query blocks are processed in chunks (bounded f32 score memory).
    """
    B, Nq, H, dh = q.shape
    Nk_loc = k_local.shape[1]
    P, L = k_means.shape[1], k_means.shape[2]
    scale = (dh ** -0.5) if scale is None else scale
    dev = q.device

    # q-chunking: bound the [B, H, Nq, Nk_loc + P·L] f32 score block
    total_k = Nk_loc + P * L
    if (q_offset == 0 and B * H * Nq * total_k * 4 > 0.5e9
            and Nq % 2 == 0 and Nq >= 256):
        C = max(Nq // 2, 128)
        while B * H * C * total_k * 4 > 0.5e9 and C % 2 == 0 and C > 128:
            C //= 2
        if Nq % C == 0:
            outs = [prism_attention(
                q[:, i:i + C], k_local, v_local, k_means, v_means, part_idx,
                seg_size, causal=causal, logit_softcap=logit_softcap,
                scale=scale, kv_mask=kv_mask, mean_counts=mean_counts,
                q_offset=i) for i in range(0, Nq, C)]
            return torch.cat(outs, dim=1)

    km_flat = k_means.reshape(B, P * L, *k_means.shape[3:])
    vm_flat = v_means.reshape(B, P * L, *v_means.shape[3:])

    # --- local block: ordinary (optionally causal) attention within X_p ---
    logits_loc = _grouped_scores(q, k_local) * scale
    logits_loc = _softcap(logits_loc, logit_softcap)
    if causal:
        qpos = q_offset + torch.arange(Nq, device=dev)[:, None]
        cmask = qpos >= torch.arange(Nk_loc, device=dev)[None, :]
        logits_loc = torch.where(cmask[None, None], logits_loc, NEG_INF)
    if kv_mask is not None:
        logits_loc = torch.where(kv_mask[:, None, None, :], logits_loc,
                                 NEG_INF)

    # --- segment-means block: scaling-aware softmax ---
    logits_mean = _grouped_scores(q, km_flat) * scale
    logits_mean = _softcap(logits_mean, logit_softcap)
    if mean_counts is None:
        logits_mean = logits_mean + torch.log(
            torch.tensor(float(seg_size), dtype=torch.float32, device=dev))
        nonempty = torch.ones((B, P * L), dtype=torch.bool, device=dev)
    else:
        counts = mean_counts.reshape(B, P * L).float()
        logits_mean = logits_mean + torch.log(
            torch.clamp(counts, min=1.0))[:, None, None, :]
        nonempty = counts > 0
    part_of_mean = torch.arange(P, device=dev).repeat_interleave(L)  # [P*L]
    if causal:
        visible = part_of_mean < part_idx                   # strictly past
    else:
        visible = part_of_mean != part_idx                  # everyone else
    logits_mean = torch.where(visible[None, None, None, :], logits_mean,
                              NEG_INF)
    logits_mean = torch.where(nonempty[:, None, None, :], logits_mean,
                              NEG_INF)

    logits = torch.cat([logits_loc, logits_mean], dim=-1)
    p_attn = torch.softmax(logits, dim=-1)
    out = (_grouped_values(p_attn[..., :Nk_loc], v_local)
           + _grouped_values(p_attn[..., Nk_loc:], vm_flat))
    return out.to(q.dtype)
