"""Single-host JAX oracles of the partitioned exchanges, for the port's
multi-rank tests.

The JAX package's own sharded path (``shard_map`` over a sequence mesh)
does not run on the installed JAX: ``scripts/sanity_exchange.py`` stops in
``repro/core/prism_attention.py`` at ``jnp.repeat`` ("pass sharding via
out_sharding").  So the oracle is composed here from the JAX package's own
functions, partition by partition: exactly the per-device body of
``repro.core.exchange.prism_prefill_attention`` (masked or unmasked
segment means of each partition's K and V, every partition's means side by
side, then ``prism_attention`` with the partition's key mask and the mean
counts), and the per-device body of ``voltage_prefill_attention`` (each
partition's queries over the whole K/V).  Both take the unpartitioned
``[B, N, ...]`` arrays and return the partitions' outputs concatenated,
so they can stand in for the exchange functions inside ``forward_vit``.
The codec exchange and the ring executor of ``repro.transport.executor``
are composed the same way (``codec_oracle``, ``ring_oracle``), and so is
the MLA latent exchange of ``repro.core.exchange.exchange_attention_mla``
and ``mla_decode_attention_sharded`` (``mla_voltage_oracle``,
``mla_prism_oracle``, ``mla_oracle`` choosing by mode,
``mla_decode_sharded_oracle``), and so is the cross-attention exchange
of ``repro.core.exchange.exchange_cross_attention`` (``cross_oracle``:
each text partition over its memory block and the other blocks' masked
means, or over the whole memory).  A
sliding-window layer takes ``voltage_oracle`` in both PRISM oracles, as
the JAX package routes it: its halo exchange attends exactly under the
window, and its codec exchange falls back to the Voltage gather.
"""
import jax.numpy as jnp

from repro.core import prism_attention as jpa
from repro.core import segment_means as jsm
from repro.kernels import dispatch as kdsp


def _parts(t, P):
    n = t.shape[1] // P
    return [t[:, p * n:(p + 1) * n] for p in range(P)]


def prism_oracle(q, k, v, cfg, *, causal=False, window=None,
                 logit_softcap=None, scale=None, kv_mask=None):
    if window is not None:               # the halo, exact under the window
        return voltage_oracle(q, k, v, cfg, causal=causal, window=window,
                              logit_softcap=logit_softcap, scale=scale,
                              kv_mask=kv_mask)
    P, L = cfg.seq_shards, cfg.L
    qs, ks, vs = _parts(q, P), _parts(k, P), _parts(v, P)
    seg = qs[0].shape[1] // L
    if kv_mask is not None:
        ms = _parts(kv_mask, P)
        kc = [jsm.segment_means_masked(ks[p], L, ms[p], axis=1)
              for p in range(P)]
        vc = [jsm.segment_means_masked(vs[p], L, ms[p], axis=1)
              for p in range(P)]
        counts = jnp.stack([c for _, c in kc], axis=1)      # [B, P, L]
        km = jnp.stack([m for m, _ in kc], axis=1)          # [B, P, L, ...]
        vm = jnp.stack([m for m, _ in vc], axis=1)
    else:
        ms = [None] * P
        counts = None
        km = jnp.stack([jsm.segment_means(ks[p], L, axis=1)
                        for p in range(P)], axis=1)
        vm = jnp.stack([jsm.segment_means(vs[p], L, axis=1)
                        for p in range(P)], axis=1)
    outs = [jpa.prism_attention(qs[p], ks[p], vs[p], km, vm, p, seg,
                                causal=causal, logit_softcap=logit_softcap,
                                scale=scale, kv_mask=ms[p],
                                mean_counts=counts)
            for p in range(P)]
    return jnp.concatenate(outs, axis=1)


def voltage_oracle(q, k, v, cfg, *, causal=False, window=None,
                   logit_softcap=None, scale=None, kv_mask=None):
    P = cfg.seq_shards
    Np = q.shape[1] // P
    outs = [jpa.reference_attention(qp, k, v, causal=causal, q_offset=p * Np,
                                    window=window, logit_softcap=logit_softcap,
                                    scale=scale, kv_mask=kv_mask)
            for p, qp in enumerate(_parts(q, P))]
    return jnp.concatenate(outs, axis=1)


def prism_decode_oracle(q, k, v, cache_len, k_means, v_means, p, P, *,
                        logit_softcap=None):
    """Shard p's body of the PRISM-decode branch of
    ``repro.core.exchange.decode_attention_sharded``, on the unsharded
    cache [B, S, ...]: its own block's valid positions and the other
    blocks' means (log(segment) scaling), one softmax."""
    B, S, Hk, dh = k.shape
    Sp = S // P
    ks, vs = k[:, p * Sp:(p + 1) * Sp], v[:, p * Sp:(p + 1) * Sp]
    scl = dh ** -0.5
    logits = jpa._softcap(jpa._grouped_scores(q, ks) * scl, logit_softcap)
    gpos = p * Sp + jnp.arange(Sp)
    valid = gpos[None, :] < jnp.reshape(jnp.asarray(cache_len), (-1, 1))
    logits = jnp.where(valid[:, None, None, :], logits, jpa.NEG_INF)
    Lm = k_means.shape[2]
    km = k_means.reshape(B, -1, Hk, dh)
    vm = v_means.reshape(B, -1, Hk, dh)
    mlog = jpa._softcap(jpa._grouped_scores(q, km) * scl, logit_softcap)
    mlog = mlog + jnp.log(jnp.asarray(max(Sp // Lm, 1), jnp.float32))
    owner = jnp.repeat(jnp.arange(P), Lm)
    mlog = jnp.where((owner != p)[None, None, None, :], mlog, jpa.NEG_INF)
    logits = jnp.concatenate([logits, mlog], axis=-1)
    w = jnp.exp(logits - jnp.max(logits, axis=-1, keepdims=True))
    o = (jpa._grouped_values(w[..., :Sp], vs)
         + jpa._grouped_values(w[..., Sp:], vm))
    return o / jnp.sum(w, axis=-1).transpose(0, 2, 1)[..., None]


def codec_oracle(q, k, v, cfg, *, causal=False, window=None,
                 logit_softcap=None, scale=None, kv_mask=None):
    """The per-device body of ``repro.transport.executor.
    codec_prefill_attention``, partition by partition: every other
    partition's K and V through the JAX codec's encode and decode, the
    own partition exact, then ``reference_attention`` of the partition's
    queries over the whole sequence under the global key mask."""
    from repro.transport.codecs import CodecSpec, get_codec
    if window is not None:               # the Voltage gather, exact
        return voltage_oracle(q, k, v, cfg, causal=causal, window=window,
                              logit_softcap=logit_softcap, scale=scale,
                              kv_mask=kv_mask)
    P = cfg.seq_shards
    codec = get_codec(cfg.codec)
    spec = CodecSpec(L=cfg.L, param=cfg.codec_param)
    ks, vs = _parts(k, P), _parts(v, P)

    def rt(t):
        return codec.decode(codec.encode(t, spec), spec, shape=t.shape,
                            dtype=t.dtype)
    k_hat, v_hat = [rt(t) for t in ks], [rt(t) for t in vs]
    Np = q.shape[1] // P
    outs = []
    for p, qp in enumerate(_parts(q, P)):
        kc = jnp.concatenate([ks[i] if i == p else k_hat[i]
                              for i in range(P)], axis=1)
        vc = jnp.concatenate([vs[i] if i == p else v_hat[i]
                              for i in range(P)], axis=1)
        outs.append(jpa.reference_attention(
            qp, kc, vc, causal=causal, q_offset=p * Np,
            logit_softcap=logit_softcap, scale=scale, kv_mask=kv_mask))
    return jnp.concatenate(outs, axis=1)


def ring_oracle(q, k, v, P, *, causal=False, logit_softcap=None,
                kv_mask=None):
    """The per-device body of ``repro.transport.executor.
    ring_prefill_attention``, partition by partition: partition p meets
    the K/V blocks in ring order p, p-1, …, each through the JAX
    ``_partial_block``, merged with the JAX ``_merge``."""
    from repro.transport import executor as jex
    Np, dh = q.shape[1] // P, q.shape[-1]
    if kv_mask is None:
        kv_mask = jnp.ones(k.shape[:2], dtype=bool)
    qs, ks, vs, ms = (_parts(t, P) for t in (q, k, v, kv_mask))
    outs = []
    for p in range(P):
        acc = None
        for s in range(P):
            src = (p - s) % P
            blk = jex._partial_block(qs[p], ks[src], vs[src], ms[src],
                                     q_offset=p * Np, kv_offset=src * Np,
                                     causal=causal, scale=dh ** -0.5,
                                     logit_softcap=logit_softcap)
            acc = blk if acc is None else jex._merge(acc, blk)
        o, _, l = acc
        outs.append(o / l.transpose(0, 2, 1)[..., None])
    return jnp.concatenate(outs, axis=1)


def _mla_expand(c, pe, w_uk, w_uv):
    """The ``expand`` of ``repro.core.exchange.exchange_attention_mla``."""
    k_nope = jnp.einsum("bnr,rhd->bnhd", c, w_uk)
    pe_b = jnp.broadcast_to(pe[:, :, None, :],
                            (*k_nope.shape[:3], pe.shape[-1]))
    return (jnp.concatenate([k_nope, pe_b], axis=-1),
            jnp.einsum("bnr,rhd->bnhd", c, w_uv))


def mla_voltage_oracle(q, c_kv, k_pe, w_uk, w_uv, cfg, *, causal=True,
                       scale=None):
    """The per-device body of the VOLTAGE branch, partition by partition:
    the whole latent re-expanded, each partition's queries at
    ``q_offset = p·Np``."""
    P = cfg.seq_shards
    Np = q.shape[1] // P
    k, v = _mla_expand(c_kv, k_pe, w_uk, w_uv)
    return jnp.concatenate(
        [jpa.chunked_reference_attention(qp, k, v, causal=causal,
                                         q_offset=p * Np, scale=scale)
         for p, qp in enumerate(_parts(q, P))], axis=1)


def mla_prism_oracle(q, c_kv, k_pe, w_uk, w_uv, cfg, *, causal=True,
                     scale=None):
    """The per-device body of the PRISM branch (``prism_mla``), partition
    by partition: the segment means of each partition's ``c_kv`` and
    ``k_pe``, every partition's means expanded, the local latent expanded,
    then ``kdsp.prism_attention``."""
    P, L = cfg.seq_shards, cfg.L
    B, _, H, dq = q.shape
    r, d_v = c_kv.shape[-1], w_uv.shape[-1]
    qs, cs, ps = _parts(q, P), _parts(c_kv, P), _parts(k_pe, P)
    seg = cs[0].shape[1] // L
    cm = jnp.stack([kdsp.segment_means(c, L, axis=1) for c in cs], axis=1)
    pm = jnp.stack([kdsp.segment_means(pe, L, axis=1) for pe in ps], axis=1)
    km, vm = _mla_expand(cm.reshape(B, P * L, r), pm.reshape(B, P * L, -1),
                         w_uk, w_uv)
    km = km.reshape(B, P, L, H, dq)
    vm = vm.reshape(B, P, L, H, d_v)
    outs = []
    for p in range(P):
        k_loc, v_loc = _mla_expand(cs[p], ps[p], w_uk, w_uv)
        outs.append(kdsp.prism_attention(qs[p], k_loc, v_loc, km, vm, p,
                                         seg, causal=causal, scale=scale))
    return jnp.concatenate(outs, axis=1)


def mla_oracle(q, c_kv, k_pe, w_uk, w_uv, cfg, *, causal=True, scale=None):
    """``exchange_attention_mla`` with the partitioned branches composed:
    VOLTAGE and PRISM through the oracles above, the rest as is."""
    from repro.core import exchange as jx
    if cfg.seq_axis is not None and cfg.seq_shards > 1:
        if cfg.mode == jx.ExchangeMode.VOLTAGE:
            return mla_voltage_oracle(q, c_kv, k_pe, w_uk, w_uv, cfg,
                                      causal=causal, scale=scale)
        if cfg.mode == jx.ExchangeMode.PRISM:
            return mla_prism_oracle(q, c_kv, k_pe, w_uk, w_uv, cfg,
                                    causal=causal, scale=scale)
    return jx.exchange_attention_mla(q, c_kv, k_pe, w_uk, w_uv, cfg,
                                     causal=causal, scale=scale)


def mla_decode_sharded_oracle(q_lat, q_pe, c_cache, pe_cache, cache_len, P,
                              *, scale):
    """The per-device body (``shard_fn``) of the sharded branch of
    ``mla_decode_attention_sharded`` on the cache [B, S, ...] split into P
    blocks: each block's logits at its offset, the global max (``pmax``),
    the summed weights and weighted latents (``psum``), then the quotient.
    ``cache_len`` is a scalar, as the JAX function takes it."""
    Sp = c_cache.shape[1] // P

    def partial_attn(c, pe, off):
        lg = (jnp.einsum("bqhr,bsr->bhqs", q_lat.astype(jnp.float32),
                         c.astype(jnp.float32))
              + jnp.einsum("bqhd,bsd->bhqs", q_pe.astype(jnp.float32),
                           pe.astype(jnp.float32))) * scale
        gpos = off + jnp.arange(c.shape[1])
        return jnp.where((gpos < cache_len)[None, None, None, :], lg,
                         jpa.NEG_INF)
    blocks = [(c_cache[:, i * Sp:(i + 1) * Sp],
               pe_cache[:, i * Sp:(i + 1) * Sp]) for i in range(P)]
    lgs = [partial_attn(c, pe, i * Sp) for i, (c, pe) in enumerate(blocks)]
    m_g = jnp.max(jnp.stack([jnp.max(lg, axis=-1, keepdims=True)
                             for lg in lgs]), axis=0)
    ws = [jnp.exp(lg - m_g) for lg in lgs]
    l_g = sum(jnp.sum(w, axis=-1) for w in ws)
    o_g = sum(jnp.einsum("bhqs,bsr->bqhr", w, c.astype(jnp.float32))
              for w, (c, _) in zip(ws, blocks))
    return (o_g / l_g.transpose(0, 2, 1)[..., None]).astype(q_lat.dtype)


def cross_oracle(q, k_mem, v_mem, mem_mask, cfg, *, logit_softcap=None,
                 scale=None):
    """``exchange_cross_attention`` with its partitioned branches composed
    partition by partition, text and memory split alike: VOLTAGE each text
    partition's queries over the whole memory under its mask; PRISM the
    per-device body (``prism_x``): each memory block's masked segment means
    of K and V (``kdsp.segment_means_masked``), every block's means and
    counts side by side, then ``kdsp.prism_attention`` of the text
    partition over its block (non-causal, the block's mask) and the means;
    the rest as is."""
    from repro.core import exchange as jx
    P, L = cfg.seq_shards, cfg.L
    if cfg.seq_axis is None or P == 1 or cfg.mode not in (
            jx.ExchangeMode.VOLTAGE, jx.ExchangeMode.PRISM):
        return jx.exchange_cross_attention(q, k_mem, v_mem, mem_mask, cfg,
                                           logit_softcap=logit_softcap,
                                           scale=scale)
    qs = _parts(q, P)
    if cfg.mode == jx.ExchangeMode.VOLTAGE:
        return jnp.concatenate(
            [jpa.reference_attention(qp, k_mem, v_mem, kv_mask=mem_mask,
                                     logit_softcap=logit_softcap, scale=scale)
             for qp in qs], axis=1)
    ks, vs, ms = _parts(k_mem, P), _parts(v_mem, P), _parts(mem_mask, P)
    kc = [kdsp.segment_means_masked(ks[p], L, ms[p], axis=1)
          for p in range(P)]
    vc = [kdsp.segment_means_masked(vs[p], L, ms[p], axis=1)
          for p in range(P)]
    km = jnp.stack([m for m, _ in kc], axis=1)              # [B, P, L, ...]
    vm = jnp.stack([m for m, _ in vc], axis=1)
    counts = jnp.stack([c for _, c in kc], axis=1)          # [B, P, L]
    seg = ks[0].shape[1] // L
    return jnp.concatenate(
        [kdsp.prism_attention(qs[p], ks[p], vs[p], km, vm, p, seg_size=seg,
                              causal=False, logit_softcap=logit_softcap,
                              scale=scale, kv_mask=ms[p], mean_counts=counts)
         for p in range(P)], axis=1)
