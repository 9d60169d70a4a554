"""Plain PyTorch version of the PRISM attention kernel (device-local view).

Port of ``repro.kernels.prism_attention.ref`` with two more inputs the CUDA
kernel takes: ``kv_mask`` on the local keys and ``q_offset`` (the global
position of ``q[0]`` under causal attention).  The means come pre-flattened
to ``[B, M, Hk, dh]`` with their visibility and scaling folded into an
additive bias ``[B, M]`` (log segment count; -1e30 to hide own / future
partitions and empty segments).  Masked scores are the value -1e30, so a
row whose every key is masked softmaxes to uniform weights, as
``repro_torch.core.prism_attention.prism_attention`` does.  ``out_dtype``
float32 returns the result before its rounding to q's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.prism_attention import (NEG_INF, _grouped_scores,
                                              _grouped_values, _softcap)


def prism_attention_ref(
    q: torch.Tensor,          # [B, Nq, H, dh]
    k_loc: torch.Tensor,      # [B, Nk, Hk, dh]
    v_loc: torch.Tensor,
    k_means: torch.Tensor,    # [B, M, Hk, dh]
    v_means: torch.Tensor,
    mean_bias: torch.Tensor,  # [B, M] additive (log counts / -1e30)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    logit_softcap: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,   # [B, Nk] bool; False → pad
    q_offset: int = 0,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    B, Nq, H, dh = q.shape
    Nk = k_loc.shape[1]
    scale = (dh ** -0.5) if scale is None else scale
    dev = q.device
    l_loc = _softcap(_grouped_scores(q, k_loc) * scale, logit_softcap)
    if causal:
        qpos = q_offset + torch.arange(Nq, device=dev)[:, None]
        keep = qpos >= torch.arange(Nk, device=dev)[None, :]
        l_loc = torch.where(keep[None, None], l_loc, NEG_INF)
    if kv_mask is not None:
        l_loc = torch.where(kv_mask[:, None, None, :], l_loc, NEG_INF)
    l_mean = _softcap(_grouped_scores(q, k_means) * scale, logit_softcap)
    l_mean = l_mean + mean_bias.float()[:, None, None, :]
    p = torch.softmax(torch.cat([l_loc, l_mean], dim=-1), dim=-1)
    out = (_grouped_values(p[..., :Nk], v_loc)
           + _grouped_values(p[..., Nk:], v_means))
    return out.to(q.dtype if out_dtype is None else out_dtype)
