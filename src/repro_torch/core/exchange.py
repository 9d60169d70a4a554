"""Exchange strategies: LOCAL / VOLTAGE / PRISM / PRISM_SIM.

Port of ``repro.core.exchange``, the part that runs on one device:

  * LOCAL     — no sequence sharding; ordinary full attention (chunked
                above a memory threshold).
  * PRISM_SIM — PRISM math (segment means + scaling-aware softmax) on
                unpartitioned tensors.
  * the single-partition branch of decode-time attention, which routes
    through the kernel-dispatch layer onto the flash-decode kernel.

The multi-partition exchanges (VOLTAGE / PRISM across a sequence mesh, the
cross-attention and MLA exchanges, and the sharded decode merge) run over
``torch.distributed`` in a later slice (ROADMAP queue 1 item 7).
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.prism_attention import (chunked_reference_attention,
                                              reference_attention)
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


def voltage_prefill_attention(q, k, v, cfg, **kw):
    """Full-tensor K/V all-gather across a sequence mesh."""
    raise NotImplementedError(_MULTI_PARTITION)


def prism_prefill_attention(q, k, v, cfg, **kw):
    """Segment-Means exchange + scaling-aware softmax across a sequence
    mesh."""
    raise NotImplementedError(_MULTI_PARTITION)


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
