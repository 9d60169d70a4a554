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
"""
import jax.numpy as jnp

from repro.core import prism_attention as jpa
from repro.core import segment_means as jsm


def _parts(t, P):
    n = t.shape[1] // P
    return [t[:, p * n:(p + 1) * n] for p in range(P)]


def prism_oracle(q, k, v, cfg, *, causal=False, window=None,
                 logit_softcap=None, scale=None, kv_mask=None):
    P, L = cfg.seq_shards, cfg.L
    assert window is None
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
