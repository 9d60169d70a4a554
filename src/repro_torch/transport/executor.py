"""Exchange executors: the ring exchange overlapped with attention, and the
codec exchange.

Port of ``repro.transport.executor``.  Each rank of a seq group calls these
with its own partition ``[B, Np, ...]`` (SPMD), where the JAX package runs
a ``shard_map`` body.

* :func:`ring_prefill_attention` — the Voltage exchange as a ring: at
  every step a rank starts the staged transfer of the K/V block it holds to
  rank ``p+1`` (``SeqGroup.ring_shift``, split into ``overlap_chunks``
  messages) *before* it computes attention against that block, so the
  transfer of step s+1 runs while the card computes block s, and merges
  the unnormalized partials with an online softmax.  The same full
  attention as the all-gather path, up to float roundoff.
* :func:`codec_prefill_attention` — the compressed exchange for the
  non-summarizing codecs (``int8``/``int4``/``topk``): encode the own K/V
  partition, gather every rank's K and V payloads in one staged call (and
  the key mask in another), decode the remote partitions, keep the own
  partition exact, and run full attention — the quantized analogue of
  PRISM's "local exact + remote compressed" scheme.
* :func:`codec_sim_attention` / :func:`codec_sim_prefill_attention` — its
  single-host form (``prism_sim`` with a codec).

The attention after an exchange, the ring's per-block attention and its
merge, and the codecs' encode and decode are plain torch, as the JAX
package's are plain jnp: no Pallas kernel sits on this path.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import exchange as xchg
from repro_torch.core.prism_attention import (NEG_INF, _grouped_scores,
                                              _grouped_values, _softcap,
                                              chunked_reference_attention,
                                              reference_attention)
from repro_torch.transport.codecs import CodecSpec, get_codec


def _spec_of(cfg) -> CodecSpec:
    return CodecSpec(L=cfg.L, param=cfg.codec_param)


# ---------------------------------------------------------------------------
# ring exchange with online-softmax merge
# ---------------------------------------------------------------------------

def _partial_block(qs, kb, vb, mb, *, q_offset, kv_offset, causal, scale,
                   logit_softcap):
    """Unnormalized attention of local queries against one K/V block:
    returns (o [B,Nq,H,dh] f32, m [B,H,Nq,1], l [B,H,Nq]).  ``mb`` is the
    block's key mask [B, Nk] or None (every key valid)."""
    Nq, Nk = qs.shape[1], kb.shape[1]
    logits = _softcap(_grouped_scores(qs, kb) * scale, logit_softcap)
    if causal:
        qpos = q_offset + torch.arange(Nq, device=qs.device)[:, None]
        kpos = kv_offset + torch.arange(Nk, device=qs.device)[None, :]
        logits = torch.where((qpos >= kpos)[None, None], logits, NEG_INF)
    if mb is not None:
        logits = torch.where(mb[:, None, None, :], logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    w = torch.exp(logits - m)
    return _grouped_values(w, vb), m, w.sum(dim=-1)


def _merge(acc, blk):
    """Online-softmax merge of two unnormalized partials."""
    o1, m1, l1 = acc
    o2, m2, l2 = blk
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    # o is [B,Nq,H,dh]; m/l carry [B,H,Nq] layout
    o = (o1 * a1[..., 0].transpose(1, 2)[..., None]
         + o2 * a2[..., 0].transpose(1, 2)[..., None])
    return o, m, l1 * a1[..., 0] + l2 * a2[..., 0]


def ring_prefill_attention(q, k, v, cfg, *, causal=False, window=None,
                           logit_softcap=None, scale=None, kv_mask=None,
                           kv_sink=None):
    """Full-tensor exchange as a ring of staged transfers, each overlapped
    with the attention of the block in hand (the chunked executor's Voltage
    path): this rank's queries [B, Np, H, dh] attend over every rank's K/V.

    Step s sends the block held (K and V in one transfer, booked as
    ``payload``; the key mask, where there is one, in another, as ``meta``)
    split into ``cfg.overlap_chunks`` messages when Np divides by it, and
    only then computes against it.  ``kv_sink`` receives the global K and V
    ``[B, P·Np, Hk, dh]`` assembled from the blocks the ring brought, in
    global order: nothing more is gathered for it.
    """
    if window is not None:
        raise NotImplementedError(
            "ring exchange does not support sliding windows; windowed "
            "layers use the halo/voltage paths")
    group = xchg.seq_group_for(cfg)
    Pn, p = group.world_size, group.rank
    Np, dh = q.shape[1], q.shape[-1]
    chunks = max(cfg.overlap_chunks, 1)
    chunks = chunks if Np % chunks == 0 else 1
    scl = (dh ** -0.5) if scale is None else scale
    kv, mb, src = torch.stack([k, v]), kv_mask, p
    blocks = {}
    acc = None
    for s in range(Pn):
        if s < Pn - 1:                  # comm for step s+1 ...
            if s == 0:
                nxt = [group.ring_shift(kv, chunks=chunks)]
                if mb is not None:
                    nxt.append(group.ring_shift(mb, kind="meta",
                                                chunks=chunks))
            else:
                nxt = [group.ring_forward(t, chunks=chunks) for t in nxt]
        blk = _partial_block(                   # ... overlaps this block
            q, kv[0], kv[1], mb, q_offset=p * Np, kv_offset=src * Np,
            causal=causal, scale=scl, logit_softcap=logit_softcap)
        acc = blk if acc is None else _merge(acc, blk)
        if kv_sink is not None:
            blocks[src] = kv
        if s < Pn - 1:
            got = [t.wait() for t in nxt]
            kv, mb, src = got[0], (got[1] if mb is not None else None), \
                (src - 1) % Pn
    if kv_sink is not None:
        kv_all = torch.cat([blocks[i] for i in range(Pn)], dim=2)
        kv_sink(kv_all[0], kv_all[1])
    o, _, l = acc
    out = o / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# generic compressed exchange (non-summarizing codecs)
# ---------------------------------------------------------------------------

def codec_prefill_attention(q, k, v, cfg, *, causal=False, window=None,
                            logit_softcap=None, scale=None, kv_mask=None,
                            kv_sink=None):
    """Codec exchange: encode this rank's K/V, gather every rank's K and V
    payloads in one staged call (``payload``; the key mask, where there is
    one, in a second, ``meta``), decode the remote partitions (the own
    partition stays exact) and attend over the whole sequence.  No exact
    global K/V exists here, so ``kv_sink`` is never called."""
    codec = get_codec(cfg.codec)
    if codec.summarizing:
        raise ValueError(f"codec {cfg.codec!r} is summarizing — it routes "
                         "through the PRISM scaling-aware path, not the "
                         "reconstruction exchange")
    if window is not None:
        # windowed layers exchange only a halo; reuse the exact voltage
        # machinery there (compression of an already-small halo is noise)
        return xchg.exchange_attention(
            q, k, v, cfg.with_mode(xchg.ExchangeMode.VOLTAGE),
            causal=causal, window=window, logit_softcap=logit_softcap,
            scale=scale, kv_mask=kv_mask, kv_sink=kv_sink)
    group = xchg.seq_group_for(cfg)
    Pn, p = group.world_size, group.rank
    B, Np = k.shape[:2]
    spec = _spec_of(cfg)
    pk, pv = codec.encode(k, spec), codec.encode(v, spec)
    names = list(pk)
    got = group.all_gather_packed([pk[n] for n in names]
                                  + [pv[n] for n in names])
    n = len(names)

    def full(own, leaves):
        parts = [own if i == p else
                 codec.decode({nm: t[i] for nm, t in zip(names, leaves)},
                              spec, shape=own.shape, dtype=own.dtype)
                 for i in range(Pn)]
        return torch.cat(parts, dim=1)
    k_hat, v_hat = full(k, got[:n]), full(v, got[n:])
    mask = None
    if kv_mask is not None:
        mask = group.all_gather(kv_mask, kind="meta")    # [P, B, Np]
        mask = mask.transpose(0, 1).reshape(B, -1)
    return chunked_reference_attention(
        q, k_hat, v_hat, causal=causal, q_offset=p * Np,
        logit_softcap=logit_softcap, scale=scale, kv_mask=mask)


def codec_sim_attention(q, k, v, P: int, codec_name: str, spec: CodecSpec,
                        *, causal: bool = False,
                        logit_softcap: Optional[float] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Single-host form of the P-rank codec exchange: every partition sees
    its own K/V exact and every other partition's through one codec
    encode→decode round trip."""
    from repro_torch.core.partition import partition_sequence
    codec = get_codec(codec_name)
    Np = q.shape[1] // P
    qp = partition_sequence(q, P)
    kp = partition_sequence(k, P)
    vp = partition_sequence(v, P)
    k_hat = [codec.decode(codec.encode(kp[i], spec), spec,
                          shape=kp[i].shape, dtype=k.dtype)
             for i in range(P)]
    v_hat = [codec.decode(codec.encode(vp[i], spec), spec,
                          shape=vp[i].shape, dtype=v.dtype)
             for i in range(P)]
    outs = []
    for p in range(P):
        kc = torch.cat([kp[i] if i == p else k_hat[i] for i in range(P)],
                       dim=1)
        vc = torch.cat([vp[i] if i == p else v_hat[i] for i in range(P)],
                       dim=1)
        outs.append(reference_attention(
            qp[p], kc.to(q.dtype), vc.to(q.dtype), causal=causal,
            q_offset=p * Np, logit_softcap=logit_softcap, scale=scale))
    return torch.cat(outs, dim=1)


def codec_sim_prefill_attention(q, k, v, cfg, *, causal=False, window=None,
                                logit_softcap=None, scale=None,
                                kv_mask=None):
    """``prism_sim``'s codec analogue: codec math on unpartitioned
    tensors (single-host validation)."""
    if window is not None:
        raise NotImplementedError("codec simulation with sliding window")
    if kv_mask is not None:
        raise NotImplementedError("codec simulation with padded kv_mask")
    return codec_sim_attention(q, k, v, cfg.seq_shards, cfg.codec,
                               _spec_of(cfg), causal=causal,
                               logit_softcap=logit_softcap, scale=scale)
