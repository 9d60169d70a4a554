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
are composed the same way (``codec_oracle``, ``ring_oracle``).  A
sliding-window layer takes ``voltage_oracle`` in both PRISM oracles, as
the JAX package routes it: its halo exchange attends exactly under the
window, and its codec exchange falls back to the Voltage gather.
"""
import jax.numpy as jnp

from repro.core import prism_attention as jpa
from repro.core import segment_means as jsm


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
