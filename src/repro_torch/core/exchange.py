"""Exchange strategies: LOCAL / VOLTAGE / PRISM / PRISM_SIM.

Port of ``repro.core.exchange``:

  * LOCAL     — no sequence sharding; ordinary full attention (chunked
                above a memory threshold).
  * VOLTAGE   — one all-gather of the full projected K/V (and the key
                mask) across the ranks of a seq group; every rank attends
                its own queries over the whole sequence.
  * PRISM     — one all-gather of L projected segment means per partition
                (and their token counts); the scaling-aware softmax over
                [local K/V ‖ remote means] runs on the PRISM-attention
                kernel.
  * PRISM_SIM — PRISM math (segment means + scaling-aware softmax) on
                unpartitioned tensors.
  * the single-partition branch of decode-time attention, which routes
    through the kernel-dispatch layer onto the flash-decode kernel.

VOLTAGE and PRISM run SPMD over a ``repro_torch.core.seq_group`` (gloo,
staged through host memory): each rank calls them with its own partition
``[B, N/P, ...]``, in place of the JAX package's ``shard_map`` body.  Not
ported yet (ROADMAP queue 1 item 7): the halo exchange of windowed layers,
the ring executor (``overlap_chunks > 0``), the cross-attention and MLA
exchanges, and the sharded decode merge.
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.prism_attention import (chunked_reference_attention,
                                              reference_attention)
from repro_torch.core.seq_group import SeqGroup, get_seq_group
from repro_torch.kernels import dispatch as kdsp

_MULTI_PARTITION = ("multi-partition exchange over a sequence mesh is not "
                    "ported yet (ROADMAP queue 1 item 7)")


class ExchangeMode(str, enum.Enum):
    LOCAL = "local"          # no sequence partitioning (single-device analogue)
    VOLTAGE = "voltage"      # full-tensor exchange (Hu & Li, ICDCS'24)
    PRISM = "prism"          # Segment Means exchange + scaling-aware softmax
    PRISM_SIM = "prism_sim"  # PRISM math on unpartitioned tensors


@dataclass(frozen=True)
class ExchangeConfig:
    """How attention communicates across the sequence-partition axis."""
    mode: ExchangeMode = ExchangeMode.LOCAL
    seq_axis: Optional[str] = None   # mesh axis carrying sequence partitions
    seq_shards: int = 1              # P — number of sequence partitions
    L: int = 0                       # segment means per partition (PRISM)
    batch_axes: tuple = ()           # mesh axes sharding the batch dim
    strategy: Optional[str] = None   # registry name when it differs from the
                                     # mode; None → mode
    codec: str = ""                  # transport codec; "" = the strategy's
                                     # default (segment_means for PRISM)
    codec_param: int = 0             # codec knob (quant tile / topk k)
    overlap_chunks: int = 0          # >0: ring exchange chunks; 0 = gather

    def with_mode(self, mode: ExchangeMode) -> "ExchangeConfig":
        return dataclasses.replace(self, mode=mode, strategy=None)


def exchange_attention(
    q: torch.Tensor,   # [B, N, H, dh]
    k: torch.Tensor,   # [B, N, Hk, dh]
    v: torch.Tensor,   # [B, N, Hk, dh]
    cfg: ExchangeConfig,
    *,
    causal: bool = False,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    scale: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,  # [B, N] bool; False → padding
) -> torch.Tensor:
    """Attention with the configured exchange, dispatched through the
    ``repro_torch.api.strategies`` registry.  Returns [B, N, H, dh]."""
    from repro_torch.api.strategies import get_strategy
    try:
        strategy = get_strategy(cfg.strategy or cfg.mode.value)
    except KeyError as e:
        raise ValueError(f"unknown exchange mode {cfg.mode}") from e
    return strategy.prefill_attention(
        q, k, v, cfg, causal=causal, window=window,
        logit_softcap=logit_softcap, scale=scale, kv_mask=kv_mask)


def local_prefill_attention(q, k, v, cfg, *, causal=False, window=None,
                            logit_softcap=None, scale=None, kv_mask=None):
    """No sequence partitioning: ordinary full attention (chunked above a
    memory threshold)."""
    B, Nq, H = q.shape[0], q.shape[1], q.shape[2]
    if B * H * Nq * k.shape[1] * 4 > 0.5e9:
        return chunked_reference_attention(
            q, k, v, causal=causal, window=window,
            logit_softcap=logit_softcap, scale=scale, kv_mask=kv_mask)
    return reference_attention(
        q, k, v, causal=causal, window=window,
        logit_softcap=logit_softcap, scale=scale, kv_mask=kv_mask)


def prism_sim_prefill_attention(q, k, v, cfg, *, causal=False, window=None,
                                logit_softcap=None, scale=None, kv_mask=None):
    """PRISM math on unpartitioned tensors (ignores ``kv_mask``, as the JAX
    package does; N must divide into P·L)."""
    from repro_torch.core.partition import simulate_prism_attention
    if window is not None:
        raise NotImplementedError("PRISM_SIM with sliding window")
    return simulate_prism_attention(
        q, k, v, cfg.seq_shards, cfg.L, causal=causal,
        logit_softcap=logit_softcap, scale=scale)


def partitioned(cfg: ExchangeConfig) -> bool:
    """Does this config run across the ranks of a seq group (each rank
    holding one sequence partition)?"""
    return (cfg.mode in (ExchangeMode.VOLTAGE, ExchangeMode.PRISM)
            and cfg.seq_axis is not None and cfg.seq_shards > 1)


def seq_group_for(cfg: ExchangeConfig) -> SeqGroup:
    """The seq group registered under ``cfg.seq_axis``; its size must be
    ``cfg.seq_shards``."""
    group = get_seq_group(cfg.seq_axis)
    if group.world_size != cfg.seq_shards:
        raise ValueError(f"seq group {cfg.seq_axis!r} has "
                         f"{group.world_size} ranks but the plan partitions "
                         f"the sequence {cfg.seq_shards} ways")
    return group


def voltage_prefill_attention(q, k, v, cfg, *, causal=False, window=None,
                              logit_softcap=None, scale=None, kv_mask=None):
    """Full-tensor K/V all-gather (the paper's Voltage baseline): this
    rank's queries [B, Np, H, dh] attend over every rank's K/V."""
    group = seq_group_for(cfg)
    B, Np = q.shape[:2]
    if kv_mask is None:
        kv_mask = torch.ones((B, Np), dtype=torch.bool, device=q.device)
    kv = group.all_gather(torch.stack([k, v]))     # [P, 2, B, Np, Hk, dh]
    kv = kv.permute(1, 2, 0, 3, 4, 5).reshape(2, B, -1, *k.shape[2:])
    mask = group.all_gather(kv_mask, meta=True)    # [P, B, Np]
    mask = mask.permute(1, 0, 2).reshape(B, -1)
    return chunked_reference_attention(
        q, kv[0], kv[1], causal=causal, q_offset=group.rank * Np,
        window=window, logit_softcap=logit_softcap, scale=scale,
        kv_mask=mask)


def prism_prefill_attention(q, k, v, cfg, *, causal=False, window=None,
                            logit_softcap=None, scale=None, kv_mask=None):
    """Segment-Means exchange + scaling-aware softmax (the paper's PRISM):
    this rank's L means of K and V go to every rank, and its queries
    attend over [local K/V ‖ every other partition's means]."""
    if window is not None:
        raise NotImplementedError("the halo exchange of windowed layers is "
                                  "not ported yet (ROADMAP queue 1 item 7)")
    group = seq_group_for(cfg)
    L = cfg.L
    seg = q.shape[1] // L
    # no mask → unmasked means and the exact log(seg) scaling bias
    if kv_mask is not None:
        km, counts = kdsp.segment_means_masked(k, L, kv_mask, axis=1)
        vm, _ = kdsp.segment_means_masked(v, L, kv_mask, axis=1)
        counts = group.all_gather(counts, meta=True).transpose(0, 1)
    else:
        km = kdsp.segment_means(k, L, axis=1)       # [B, L, Hk, dh]
        vm = kdsp.segment_means(v, L, axis=1)
        counts = None
    means = group.all_gather(torch.stack([km, vm]))  # [P, 2, B, L, Hk, dh]
    means = means.permute(1, 2, 0, 3, 4, 5)          # [2, B, P, L, Hk, dh]
    return kdsp.prism_attention(q, k, v, means[0], means[1], group.rank, seg,
                                causal=causal, logit_softcap=logit_softcap,
                                scale=scale, kv_mask=kv_mask,
                                mean_counts=counts)


def decode_attention_sharded(
    q: torch.Tensor,        # [B, 1, H, dh]
    k_cache: torch.Tensor,  # [B, S, Hk, dh]
    v_cache: torch.Tensor,  # [B, S, Hk, dh]
    cache_len,              # [B] or scalar — valid prefix length
    cfg: ExchangeConfig,
    *,
    logit_softcap: Optional[float] = None,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    k_means: Optional[torch.Tensor] = None,
    v_means: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One-token attention against the cache.

    With no sequence mesh (LOCAL, PRISM_SIM, or one shard) the cache is
    device-local and the exact answer goes through the kernel-dispatch
    layer: the flash-decode kernel on a CUDA tensor, its plain version on
    a CPU tensor.  A position-sharded cache with its LSE-merge collective
    is ROADMAP queue 1 item 7.
    """
    if (cfg.mode in (ExchangeMode.LOCAL, ExchangeMode.PRISM_SIM)
            or cfg.seq_axis is None or cfg.seq_shards == 1):
        return kdsp.decode_attention(q, k_cache, v_cache, cache_len,
                                     window=window,
                                     logit_softcap=logit_softcap,
                                     scale=scale)
    raise NotImplementedError(_MULTI_PARTITION)
