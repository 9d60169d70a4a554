"""Exchange strategies: LOCAL / VOLTAGE / PRISM / PRISM_SIM.

Port of ``repro.core.exchange``:

  * LOCAL     — no sequence sharding; ordinary full attention (chunked
                above a memory threshold).
  * VOLTAGE   — one all-gather of the full projected K/V (and the key
                mask, where there is one) across the ranks of a seq group;
                every rank attends its own queries over the whole sequence.
  * PRISM     — one all-gather of L projected segment means per partition
                (and their token counts); the scaling-aware softmax over
                [local K/V ‖ remote means] runs on the PRISM-attention
                kernel.  A causal sliding-window layer whose window spans
                fewer than P − 1 partitions exchanges only its halo: the
                preceding partitions the window reaches, point to point.
  * PRISM_SIM — PRISM math on unpartitioned tensors.
  * decode-time attention: with one partition the cache is device-local
    and goes through the kernel-dispatch layer onto the flash-decode
    kernel; across a seq group each rank holds a contiguous block of the
    cache's positions, takes its partial softmax on the flash-decode
    kernel under global validity, and one gather of the partials per call
    merges them exactly (log-sum-exp) on every rank.

VOLTAGE and PRISM run SPMD over a ``repro_torch.core.seq_group`` (gloo,
staged through host memory): each rank calls them with its own partition
``[B, N/P, ...]``, in place of the JAX package's ``shard_map`` body.
VOLTAGE with ``overlap_chunks > 0`` runs the ring executor and PRISM with
a non-default codec the codec exchange (``repro_torch.transport.
executor``).  The MLA latent exchange (``exchange_attention_mla``,
DeepSeek-V2) moves ``[c_kv ‖ k_pe]`` instead of K/V: VOLTAGE gathers the
latent, PRISM its segment means, and every rank expands what it holds
with the up-projections; its decode merges each rank's latent-space
partials (``mla_decode_attention_sharded``).  The cross-attention
exchange (``exchange_cross_attention``: whisper's encoder memory,
llama-3.2-vision's image tokens) partitions the memory as the text: each
rank attends its text partition over its memory block and the other
blocks' K/V (VOLTAGE) or their masked segment means (PRISM).
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.core.prism_attention import (NEG_INF, _grouped_scores,
                                              _grouped_values, _softcap,
                                              chunked_reference_attention,
                                              reference_attention)
from repro_torch.core.seq_group import SeqGroup, get_seq_group
from repro_torch.kernels import dispatch as kdsp
from repro_torch.kernels.flash_decode.ops import (merge_partials,
                                                  validity_mask)


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
    kv_sink: Optional[Callable] = None,
) -> torch.Tensor:
    """Attention with the configured exchange, dispatched through the
    ``repro_torch.api.strategies`` registry.  Returns [B, N, H, dh].

    ``kv_sink`` (partitioned plans only): called with the global K and V
    ``[B, P·Np, Hk, dh]`` by an exchange that gathers them in full
    (VOLTAGE), so a prefill can fill its cache block from them; PRISM
    gathers only means and never calls it."""
    from repro_torch.api.strategies import get_strategy
    try:
        strategy = get_strategy(cfg.strategy or cfg.mode.value)
    except KeyError as e:
        raise ValueError(f"unknown exchange mode {cfg.mode}") from e
    kw = {} if kv_sink is None else {"kv_sink": kv_sink}
    return strategy.prefill_attention(
        q, k, v, cfg, causal=causal, window=window,
        logit_softcap=logit_softcap, scale=scale, kv_mask=kv_mask, **kw)


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
    ``cfg.seq_shards``.  On a ``("data", "model")`` mesh the plan's
    ``seq_axis`` is ``"model"``: the rank's row (a model axis of 1 leaves
    the plan unpartitioned, and nothing asks for a group)."""
    group = get_seq_group(cfg.seq_axis)
    if group.world_size != cfg.seq_shards:
        raise ValueError(f"seq group {cfg.seq_axis!r} has "
                         f"{group.world_size} ranks but the plan partitions "
                         f"the sequence {cfg.seq_shards} ways")
    return group


def gather_kv(group: SeqGroup, k: torch.Tensor, v: torch.Tensor,
              kind: str = "payload"):
    """Every rank's K and V ``[B, Np, Hk, dh]`` in one gather → the global
    ``[B, P·Np, Hk, dh]`` K and V, rank p's at positions
    ``[p·Np, (p+1)·Np)``; the bytes are booked under ``kind``."""
    kv = group.all_gather(torch.stack([k, v]), kind=kind)
    kv = kv.permute(1, 2, 0, 3, 4, 5).reshape(2, k.shape[0], -1, *k.shape[2:])
    return kv[0], kv[1]


def voltage_prefill_attention(q, k, v, cfg, *, causal=False, window=None,
                              logit_softcap=None, scale=None, kv_mask=None,
                              kv_sink=None):
    """Full-tensor K/V all-gather (the paper's Voltage baseline): this
    rank's queries [B, Np, H, dh] attend over every rank's K/V.  Without a
    key mask (on every rank, as SPMD calls are alike) no mask is
    gathered; ``kv_sink`` receives the gathered K and V.

    With ``cfg.overlap_chunks > 0`` (and no sliding window) the exchange
    runs through the ring executor instead: staged block transfers
    overlapped with per-block attention."""
    if cfg.overlap_chunks > 0 and window is None:
        from repro_torch.transport.executor import ring_prefill_attention
        return ring_prefill_attention(q, k, v, cfg, causal=causal,
                                      logit_softcap=logit_softcap,
                                      scale=scale, kv_mask=kv_mask,
                                      kv_sink=kv_sink)
    group = seq_group_for(cfg)
    B, Np = q.shape[:2]
    k_all, v_all = gather_kv(group, k, v)
    if kv_sink is not None:
        kv_sink(k_all, v_all)
    mask = None
    if kv_mask is not None:
        mask = group.all_gather(kv_mask, kind="meta")   # [P, B, Np]
        mask = mask.permute(1, 0, 2).reshape(B, -1)
    return chunked_reference_attention(
        q, k_all, v_all, causal=causal, q_offset=group.rank * Np,
        window=window, logit_softcap=logit_softcap, scale=scale,
        kv_mask=mask)


def prism_prefill_attention(q, k, v, cfg, *, causal=False, window=None,
                            logit_softcap=None, scale=None, kv_mask=None,
                            kv_sink=None):
    """Segment-Means exchange + scaling-aware softmax (the paper's PRISM):
    this rank's L means of K and V go to every rank, and its queries
    attend over [local K/V ‖ every other partition's means].  It gathers
    no full K/V, so ``kv_sink`` is never called.

    A sliding-window layer needs no means: far context is outside the
    window.  Causal, with ``n_halo = ceil(window / Np)`` partitions of
    history below P − 1, the rank receives the K and V of the ``n_halo``
    partitions before it (``SeqGroup.shift``, one staged call each, K and
    V in one buffer; a rank with fewer predecessors gets zeros, masked)
    and attends exactly over [halo ‖ own] under the window; the key mask
    is not read, as in the JAX package.  Under autograd the shift's
    backward sends each halo block's cotangent back to its source, and a
    zero block's (no source) goes nowhere; the position mask is boolean.
    Otherwise the layer takes the Voltage gather (``kv_sink`` and the
    mask passed on)."""
    group = seq_group_for(cfg)
    if window is not None:
        P, p, Np = group.world_size, group.rank, q.shape[1]
        n_halo = min(-(-window // max(Np, 1)), P - 1)
        if not (causal and n_halo < P - 1):
            return exchange_attention(
                q, k, v, cfg.with_mode(ExchangeMode.VOLTAGE), causal=causal,
                window=window, logit_softcap=logit_softcap, scale=scale,
                kv_mask=kv_mask, kv_sink=kv_sink)
        halo = [group.shift(torch.stack([k, v]), sft)
                for sft in range(n_halo, 0, -1)]
        kg = torch.cat([h[0] for h in halo] + [k], dim=1)
        vg = torch.cat([h[1] for h in halo] + [v], dim=1)
        gpos = (p - n_halo) * Np + torch.arange((n_halo + 1) * Np,
                                                device=q.device)
        return chunked_reference_attention(
            q, kg, vg, causal=True, q_offset=n_halo * Np, window=window,
            logit_softcap=logit_softcap, scale=scale,
            kv_mask=(gpos >= 0)[None].expand(q.shape[0], -1))
    L = cfg.L
    seg = q.shape[1] // L
    # K and V means in one launch, gathered as they come out; no mask →
    # unmasked means and the exact log(seg) scaling bias
    kv_means, counts = kdsp.segment_means_kv(k, v, L, kv_mask, axis=1)
    counts = (None if kv_mask is None
              else group.all_gather(counts, kind="meta").transpose(0, 1))
    means = group.all_gather(kv_means)               # [P, 2, B, L, Hk, dh]
    means = means.permute(1, 2, 0, 3, 4, 5)          # [2, B, P, L, Hk, dh]
    return kdsp.prism_attention(q, k, v, means[0], means[1], group.rank, seg,
                                causal=causal, logit_softcap=logit_softcap,
                                scale=scale, kv_mask=kv_mask,
                                mean_counts=counts)


def exchange_cross_attention(
    q: torch.Tensor,         # [B, Nq, H, dh] — this rank's text partition
    k_mem: torch.Tensor,     # [B, M, Hk, dh] — this rank's memory block
    v_mem: torch.Tensor,     # [B, M, Hk, dh]
    mem_mask: torch.Tensor,  # [B, M] bool — False for padding
    cfg: ExchangeConfig,
    *,
    logit_softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Cross-attention of text queries onto a position-partitioned memory
    (the paper's exchange applied to an encoder or image memory) →
    [B, Nq, H, dh].

    LOCAL / PRISM_SIM (and one partition): exact attention under the
    memory mask.  Across a seq group rank p holds its text partition and
    memory block ``[p·Mp, (p+1)·Mp)`` (the two lengths differ):

    * VOLTAGE: one gather of the block's K and V and one of its mask
      (``meta``), then attention over the whole memory;
    * PRISM: the masked segment means of the block's K and V in one
      segment-means launch, one gather of the means and one of their
      counts (``meta``), then the PRISM-attention kernel, non-causal, over
      [the block under its mask ‖ every other block's means], each mean
      weighted by its count (an all-padding segment weighs 0).
    """
    if not partitioned(cfg):
        return local_prefill_attention(q, k_mem, v_mem, cfg,
                                       logit_softcap=logit_softcap,
                                       scale=scale, kv_mask=mem_mask)
    group = seq_group_for(cfg)
    B = q.shape[0]
    if cfg.mode == ExchangeMode.VOLTAGE:
        k_all, v_all = gather_kv(group, k_mem, v_mem)
        mask = group.all_gather(mem_mask, kind="meta")      # [P, B, M]
        return chunked_reference_attention(
            q, k_all, v_all, logit_softcap=logit_softcap, scale=scale,
            kv_mask=mask.permute(1, 0, 2).reshape(B, -1))
    L = cfg.L
    kv_means, counts = kdsp.segment_means_kv(k_mem, v_mem, L, mem_mask,
                                             axis=1)
    counts = group.all_gather(counts, kind="meta").transpose(0, 1)
    means = group.all_gather(kv_means)               # [P, 2, B, L, Hk, dh]
    means = means.permute(1, 2, 0, 3, 4, 5)          # [2, B, P, L, Hk, dh]
    return kdsp.prism_attention(q, k_mem, v_mem, means[0], means[1],
                                group.rank, k_mem.shape[1] // L,
                                causal=False, logit_softcap=logit_softcap,
                                scale=scale, kv_mask=mem_mask,
                                mean_counts=counts)


def decode_attention_sharded(
    q: torch.Tensor,        # [B, 1, H, dh] — the same on every rank
    k_cache: torch.Tensor,  # [B, S, Hk, dh] — this rank's block of S
    v_cache: torch.Tensor,  # [B, S, Hk, dh]
    cache_len,              # [B] or scalar — valid prefix length (global)
    cfg: ExchangeConfig,
    *,
    logit_softcap: Optional[float] = None,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    k_means: Optional[torch.Tensor] = None,  # [B, P, L, Hk, dh] PRISM-decode
    v_means: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One-token attention against the cache.

    With no sequence mesh (LOCAL, PRISM_SIM, or one shard) the cache is
    device-local and the exact answer goes through the kernel-dispatch
    layer: the flash-decode kernel on a CUDA tensor, its plain version on
    a CPU tensor.

    Across a seq group rank p holds positions ``[p·Sp, (p+1)·Sp)``.
    VOLTAGE (and PRISM without means): each rank's partial softmax under
    global validity on the flash-decode kernel, one gather of the packed
    partials, and the exact log-sum-exp merge, summed in rank order so
    every rank holds bitwise the same output (``merge_partials``; a block
    with no valid position weighs 0).  PRISM-decode (``k_means``
    given): the rank attends its own block and the locally held means of
    the other blocks, with no collective (plain torch, as the JAX package
    computes it in plain jnp).
    """
    if not partitioned(cfg):
        return kdsp.decode_attention(q, k_cache, v_cache, cache_len,
                                     window=window,
                                     logit_softcap=logit_softcap,
                                     scale=scale)
    group = seq_group_for(cfg)
    offset = group.rank * k_cache.shape[1]
    if cfg.mode == ExchangeMode.PRISM and k_means is not None:
        return _prism_decode(q, k_cache, v_cache, cache_len, group.rank,
                             offset, k_means, v_means, window=window,
                             logit_softcap=logit_softcap, scale=scale)
    o, m, l = kdsp.decode_partials(q, k_cache, v_cache, cache_len,
                                   offset=offset, window=window,
                                   logit_softcap=logit_softcap, scale=scale)
    parts = group.all_gather(torch.cat([o, m[..., None], l[..., None]],
                                       dim=-1), kind="merge")
    out = merge_partials(parts[..., :-2], parts[..., -2], parts[..., -1])
    return out.to(q.dtype)[:, None]


def _prism_decode(q, k_cache, v_cache, cache_len, rank, offset, k_means,
                  v_means, *, window, logit_softcap, scale):
    """PRISM-decode on one rank: its own block's valid positions and the
    means of the other ranks' blocks (``[B, P, L, Hk, dh]``, own block
    hidden, log(segment) scaling), in one softmax."""
    B, Sp, Hk, dh = k_cache.shape
    Pn, Lm = k_means.shape[1], k_means.shape[2]
    scl = (dh ** -0.5) if scale is None else scale
    logits = _softcap(_grouped_scores(q, k_cache) * scl, logit_softcap)
    valid = validity_mask(B, Sp, cache_len, offset=offset, window=window,
                          device=q.device)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    km = k_means.reshape(B, -1, Hk, dh)
    vm = v_means.reshape(B, -1, Hk, dh)
    seg = max(Sp // max(Lm, 1), 1)
    mlog = (_softcap(_grouped_scores(q, km) * scl, logit_softcap)
            + torch.log(torch.tensor(float(seg))))
    owner = torch.arange(Pn, device=q.device).repeat_interleave(Lm)
    mlog = torch.where((owner != rank)[None, None, None, :], mlog, NEG_INF)
    logits = torch.cat([logits, mlog], dim=-1)
    w = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    o = _grouped_values(w[..., :Sp], v_cache) + _grouped_values(w[..., Sp:],
                                                                vm)
    denom = w.sum(dim=-1).transpose(1, 2)[..., None]
    return (o / denom).to(q.dtype)


# ---------------------------------------------------------------------------
# MLA latent exchange (DeepSeek-V2): compress-then-exchange the latent c_kv
# ---------------------------------------------------------------------------

def _mla_expand(c: torch.Tensor, pe: torch.Tensor, w_uk: torch.Tensor,
                w_uv: torch.Tensor):
    """Latent ``c`` [B, n, r] and rotary key ``pe`` [B, n, dr] → K
    [B, n, H, d_nope + dr] (``pe`` shared by every head) and V
    [B, n, H, d_v]."""
    k_nope = torch.einsum("bnr,rhd->bnhd", c, w_uk)
    pe_b = pe[:, :, None, :].expand(*k_nope.shape[:3], pe.shape[-1])
    k = torch.cat([k_nope, pe_b], dim=-1)
    v = torch.einsum("bnr,rhd->bnhd", c, w_uv)
    return k, v


def exchange_attention_mla(
    q: torch.Tensor,        # [B, N, H, dq]  (dq = nope + rope)
    c_kv: torch.Tensor,     # [B, N, r]      latent KV (post-norm)
    k_pe: torch.Tensor,     # [B, N, dr]     shared rotary key
    w_uk: torch.Tensor,     # [r, H, d_nope] up-projection for keys
    w_uv: torch.Tensor,     # [r, H, d_v]    up-projection for values
    cfg: ExchangeConfig,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    latent_sink: Optional[Callable] = None,
) -> torch.Tensor:
    """Attention over the MLA latent → [B, N, H, d_v].

    LOCAL / PRISM_SIM (and one partition): expand, then exact attention
    (chunked above a memory threshold).  Across a seq group each rank
    holds its partition ``[B, Np, ...]``:

    * VOLTAGE: one gather of the latent ``[c_kv ‖ k_pe]`` ``[B, Np, r +
      dr]``; every rank re-expands the whole of it and attends its queries
      at ``q_offset = p·Np``.  ``latent_sink`` receives the gathered
      ``[B, P·Np, r + dr]`` (a prefill fills its cache block from it).
    * PRISM: the segment means of ``[c_kv ‖ k_pe]`` in one segment-means
      launch (per column, the means of the concatenation are the
      concatenation of the means the JAX package takes apart), one gather,
      then the local latent and every partition's means expanded (the
      up-projections are linear: mean-then-expand is expand-then-mean) and
      the PRISM-attention kernel, K width d_nope + dr, V width d_v.
    """
    r = c_kv.shape[-1]
    if not partitioned(cfg):
        k, v = _mla_expand(c_kv, k_pe, w_uk, w_uv)
        B, Nq, H = q.shape[:3]
        if B * H * Nq * k.shape[1] * 4 > 0.5e9:
            return chunked_reference_attention(q, k, v, causal=causal,
                                               scale=scale)
        return reference_attention(q, k, v, causal=causal, scale=scale)
    group = seq_group_for(cfg)
    B, Np, H, dq = q.shape
    lat = torch.cat([c_kv, k_pe], dim=-1)                    # [B, Np, r+dr]
    if cfg.mode == ExchangeMode.VOLTAGE:
        lat_all = group.all_gather(lat).permute(1, 0, 2, 3).reshape(
            B, -1, lat.shape[-1])
        if latent_sink is not None:
            latent_sink(lat_all)
        k, v = _mla_expand(lat_all[..., :r], lat_all[..., r:], w_uk, w_uv)
        return chunked_reference_attention(q, k, v, causal=causal,
                                           q_offset=group.rank * Np,
                                           scale=scale)
    L = cfg.L
    P = group.world_size
    means = group.all_gather(kdsp.segment_means(lat, L, axis=1))  # [P,B,L,·]
    means = means.transpose(0, 1).reshape(B, P * L, -1)
    k_loc, v_loc = _mla_expand(c_kv, k_pe, w_uk, w_uv)
    km, vm = _mla_expand(means[..., :r], means[..., r:], w_uk, w_uv)
    return kdsp.prism_attention(q, k_loc, v_loc,
                                km.reshape(B, P, L, H, dq),
                                vm.reshape(B, P, L, H, -1), group.rank,
                                Np // L, causal=causal, scale=scale)


def _mla_partials(q_lat, q_pe, c, pe, cache_len, offset: int, scale: float):
    """One block's latent-space partial softmax → (o·l [B, H, r], m [B, H],
    l [B, H]) f32.  Positions at or past the global ``cache_len`` score
    -1e30, so a block with no valid one gives m = -1e30."""
    lg = (torch.einsum("bqhr,bsr->bhqs", q_lat.float(), c.float())
          + torch.einsum("bqhd,bsd->bhqs", q_pe.float(), pe.float())) * scale
    B, S = c.shape[:2]
    valid = validity_mask(B, S, cache_len, offset=offset, device=c.device)
    lg = torch.where(valid[:, None, None, :], lg, NEG_INF)[:, :, 0]
    m = lg.amax(dim=-1)                                      # [B, H]
    w = torch.exp(lg - m[..., None])
    return torch.einsum("bhs,bsr->bhr", w, c.float()), m, w.sum(dim=-1)


def mla_decode_attention_sharded(
    q_lat: torch.Tensor,    # [B, 1, H, r]  absorbed no-pe query
    q_pe: torch.Tensor,     # [B, 1, H, dr] rotary query
    c_cache: torch.Tensor,  # [B, S, r]     latent cache (this rank's block)
    pe_cache: torch.Tensor,  # [B, S, dr]
    cache_len,              # [B] or scalar — global valid prefix
    cfg: ExchangeConfig,
    *,
    scale: float,
) -> torch.Tensor:
    """One-token absorbed MLA attention over the latent cache → [B, 1, H,
    r] in ``q_lat``'s dtype (plain torch, as the JAX package's is plain
    jnp).  Across a seq group rank p holds positions ``[p·Sp, (p+1)·Sp)``:
    each rank's partial softmax over its block, one gather of the packed
    ``[B, H, r + 2]`` partials (booked as ``merge``), and the exact
    log-sum-exp merge in rank order (``merge_partials``)."""
    if not partitioned(cfg):
        o, m, l = _mla_partials(q_lat, q_pe, c_cache, pe_cache, cache_len, 0,
                                scale)
        return (o / l[..., None]).to(q_lat.dtype)[:, None]
    group = seq_group_for(cfg)
    o, m, l = _mla_partials(q_lat, q_pe, c_cache, pe_cache, cache_len,
                            group.rank * c_cache.shape[1], scale)
    parts = group.all_gather(torch.cat([o, m[..., None], l[..., None]],
                                       dim=-1), kind="merge")
    out = merge_partials(parts[..., :-2], parts[..., -2], parts[..., -1])
    return out.to(q_lat.dtype)[:, None]
