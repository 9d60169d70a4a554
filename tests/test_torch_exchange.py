"""The port's Voltage and PRISM exchanges across 2 and 4 gloo ranks on the
CPU, against the JAX package's per-partition oracle, in f32.

Each world size runs all its cases in one spawn (``seq_group.spawn``, one
process per rank, join timeout 120 s).  Rank p runs ``exchange_attention``
on its partition ``[B, N/P, ...]``; the partitions' outputs, concatenated,
are held against ``tests/_exchange_oracle.py`` (the JAX package's own
functions composed partition by partition — its ``shard_map`` path does
not run on the installed JAX) at atol = rtol = 1e-5.  The bytes each rank
received in its K/V gathers are held against the transport accounting.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks
from _exchange_oracle import prism_oracle, voltage_oracle
from repro.core.exchange import ExchangeConfig as JConfig
from repro.core.exchange import ExchangeMode as JMode
from repro_torch.core.seq_group import spawn
from repro_torch.transport import exchange_wire_bytes

B, N, H, DH = 2, 40, 4, 16
# (mode, causal, masked, Hk, softcap); L is N / (P · 5): 5 tokens a segment
CASES = [("voltage", False, True, 4, None),
         ("voltage", True, False, 2, 30.0),
         ("prism", False, True, 2, None),
         ("prism", True, False, 2, None),
         ("prism", False, False, 4, 20.0),
         ("prism", True, True, 1, None)]


def _cases(P):
    r = np.random.RandomState(P)
    out = []
    for mode, causal, masked, hk, cap in CASES:
        c = dict(mode=mode, causal=causal, softcap=cap, L=N // (P * 5),
                 q=r.randn(B, N, H, DH).astype(np.float32),
                 k=r.randn(B, N, hk, DH).astype(np.float32),
                 v=r.randn(B, N, hk, DH).astype(np.float32))
        if masked:
            m = r.rand(B, N) > 0.3
            m[0, :5] = False                  # an empty segment
            m[1, 20:] = False                 # padding at the tail
            c["kv_mask"] = m
        out.append(c)
    return out


_RUNS = {}


def _run(P):
    if P not in _RUNS:
        cases = _cases(P)
        per_rank = spawn(_torch_ranks.exchange_cases, P, cases, timeout=120)
        outs = [np.concatenate([per_rank[r][i][0] for r in range(P)], axis=1)
                for i in range(len(cases))]
        _RUNS[P] = cases, outs, [sum(c[1] for c in r) for r in per_rank]
    return _RUNS[P]


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("i", range(len(CASES)))
def test_exchange_matches_the_per_partition_oracle(P, i):
    cases, outs, _ = _run(P)
    c = cases[i]
    cfg = JConfig(JMode(c["mode"]), seq_axis="seq", seq_shards=P, L=c["L"])
    oracle = prism_oracle if c["mode"] == "prism" else voltage_oracle
    mask = c.get("kv_mask")
    want = oracle(jnp.asarray(c["q"]), jnp.asarray(c["k"]),
                  jnp.asarray(c["v"]), cfg, causal=c["causal"],
                  logit_softcap=c["softcap"],
                  kv_mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(outs[i], np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("P", [2, 4])
def test_gathered_bytes_equal_the_transport_accounting(P):
    """Every rank received exactly what ``exchange_wire_bytes`` charges for
    its codec, with K and V as the per-token payload (2·Hk·dh wide)."""
    cases, _, received = _run(P)
    want = sum(exchange_wire_bytes(
        "segment_means" if c["mode"] == "prism" else "identity",
        n_tokens=N, d_model=2 * c["k"].shape[2] * DH, bytes_per_el=4,
        batch=B, P=P, n_layers=1, L=c["L"]) for c in cases)
    assert received == [want] * P


_ROUTES = {}


def _routes():
    """Plain ``prism`` and ``voltage`` beside the variants the JAX package
    routes to them, on 2 ranks: ``prism`` ignores ``overlap_chunks``,
    ``voltage`` never reads the codec."""
    if not _ROUTES:
        r = np.random.RandomState(7)
        qkv = dict(q=r.randn(B, N, H, DH).astype(np.float32),
                   k=r.randn(B, N, 2, DH).astype(np.float32),
                   v=r.randn(B, N, 2, DH).astype(np.float32),
                   kv_mask=r.rand(B, N) > 0.2)
        cases = [dict(mode="prism", L=4, causal=True, **qkv),
                 dict(mode="prism", L=4, causal=True, overlap_chunks=2,
                      **qkv),
                 dict(mode="voltage", causal=False, **qkv),
                 dict(mode="voltage", causal=False, codec="int8", **qkv)]
        per_rank = spawn(_torch_ranks.exchange_cases, 2, cases,
                         timeout=120)
        _ROUTES.update(
            (name, [r[i] for r in per_rank]) for i, name in enumerate(
                ("prism", "prism+overlap", "voltage", "voltage+int8")))
    return _ROUTES


@pytest.mark.parametrize("variant", ["prism+overlap", "voltage+int8",
                                     "window"])
def test_exchange_variants_route_as_the_reference(variant):
    """Each variant does what the JAX package does with it: a ``prism``
    plan with ``overlap_chunks`` and a ``voltage`` plan with a codec give
    their plain plan's output and bytes; a windowed layer under the ring
    executor raises as the JAX package's ``ring_prefill_attention`` does."""
    if variant == "window":
        import torch
        from repro.transport.executor import \
            ring_prefill_attention as jax_ring
        from repro_torch.core.exchange import ExchangeConfig, ExchangeMode
        from repro_torch.transport.executor import ring_prefill_attention
        xcfg = ExchangeConfig(ExchangeMode.VOLTAGE, seq_axis="seq",
                              seq_shards=2, overlap_chunks=2)
        jcfg = JConfig(JMode.VOLTAGE, seq_axis="seq", seq_shards=2,
                       overlap_chunks=2)
        q = torch.zeros(1, 8, 2, 16)
        with pytest.raises(NotImplementedError) as want:
            jax_ring(jnp.zeros((1, 8, 2, 16)), jnp.zeros((1, 8, 2, 16)),
                     jnp.zeros((1, 8, 2, 16)), jcfg, window=4)
        with pytest.raises(NotImplementedError) as got:
            ring_prefill_attention(q, q, q, xcfg, causal=True, window=4)
        assert str(got.value) == str(want.value)
        return
    runs = _routes()
    plain = runs[variant.split("+")[0]]
    for (out, *stats, _), (want, *want_stats, _) in zip(runs[variant],
                                                        plain):
        np.testing.assert_array_equal(out, want)
        assert stats == want_stats


def test_a_partitioned_plan_needs_its_seq_group():
    import torch
    from repro_torch.core.exchange import (ExchangeConfig, ExchangeMode,
                                           exchange_attention)
    xcfg = ExchangeConfig(ExchangeMode.VOLTAGE, seq_axis="seq", seq_shards=2)
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(RuntimeError, match="init_seq_group"):
        exchange_attention(q, q, q, xcfg)
