"""MLA (DeepSeek-V2's multi-head latent attention) in the port against the
JAX package's ``repro.models.mla`` and ``exchange_attention_mla`` /
``mla_decode_attention_sharded`` at small widths in f32, the same numpy
weights on both sides (tolerances: modules 1e-5):

* ``init_mla``'s layout (``w_uk`` and ``w_uv`` stored ``[r, H, d]``) and
  ``init_mla_cache``;
* ``mla_block`` under ``local`` and ``prism_sim`` (the exact path in both
  packages), and the chunked exact path above its memory threshold;
* ``mla_prefill``: the output and the latent cache it writes;
* ``mla_decode`` (the absorbed form over the latent cache) step by step
  from the JAX cache, and with a ``[B]`` cache index (one position and
  one valid prefix per row, each row the JAX package's B 1 step);
* the PRISM-attention kernel wrapper's plain version at the MLA widths
  (keys ``d_nope + d_rope``, values ``d_v``) against the JAX package's
  ``prism_attention``, which ``repro.kernels.dispatch`` resolves to off
  the TPU (the Pallas kernel takes one head dim for q, K, V and the
  output, so it was not written for this shape).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MLACfg as JMLACfg
from repro.core import exchange as jx
from repro.core import prism_attention as jpa
from repro.models import mla as jmla
from repro_torch.configs.base import MLACfg
from repro_torch.core import exchange as tx
from repro_torch.models import mla as tmla
from repro_torch.models.bridge import tensor_from_numpy

D, H = 48, 4
DIMS = dict(kv_lora_rank=24, q_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
            v_head_dim=12)
JCFG, TCFG = JMLACfg(**DIMS), MLACfg(**DIMS)
TOL = 1e-5


def _weights(seed=0):
    """The JAX ``init_mla`` (f32), with nonzero norm scales → (numpy
    leaves, the port's tensors)."""
    p = jax.tree.map(np.asarray, jmla.init_mla(jax.random.PRNGKey(seed), D,
                                               H, JCFG, jnp.float32))
    rng = np.random.RandomState(seed)
    for name in ("q_norm", "kv_norm"):
        p[name]["scale"] = rng.randn(*p[name]["scale"].shape).astype(
            np.float32) * 0.1
    return p, jax.tree.map(tensor_from_numpy, p)


def _x(B, N, seed):
    return np.random.RandomState(seed).randn(B, N, D).astype(np.float32)


def _diff(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def test_init_mla_has_the_jax_layout():
    jp, _ = _weights()
    gen = torch.Generator().manual_seed(0)
    tp = tmla.init_mla(gen, D, H, TCFG, torch.float32)
    assert set(tp) == set(jp)
    for name, leaf in jp.items():
        got = tp[name]["scale"] if isinstance(leaf, dict) else tp[name]
        want = leaf["scale"] if isinstance(leaf, dict) else leaf
        assert tuple(got.shape) == want.shape
    assert tuple(tp["w_uk"].shape) == (24, H, 16)
    assert tuple(tp["w_uv"].shape) == (24, H, 12)
    jc = jmla.init_mla_cache(3, 10, JCFG, jnp.float32)
    tc = tmla.init_mla_cache(3, 10, TCFG, torch.float32)
    assert {k: v.shape for k, v in jc.items()} == {
        k: tuple(v.shape) for k, v in tc.items()}


@pytest.mark.parametrize("plan", ["local", "prism_sim"])
def test_mla_block_matches_jax(plan):
    jp, tp = _weights(1)
    x = _x(2, 16, 2)
    xj = (jx.ExchangeConfig() if plan == "local" else jx.ExchangeConfig(
        jx.ExchangeMode.PRISM_SIM, seq_shards=2, L=4))
    xt = tx.ExchangeConfig(tx.ExchangeMode(xj.mode.value),
                           seq_shards=xj.seq_shards, L=xj.L)
    want = jmla.mla_block(jp, jnp.asarray(x), H, JCFG, xj)
    got = tmla.mla_block(tp, torch.from_numpy(x), H, TCFG, xt)
    assert got.shape == (2, 16, D)
    assert _diff(got.numpy(), want) <= TOL


def test_exchange_attention_mla_chunks_above_its_threshold(monkeypatch):
    """Below ``B·H·Nq·Nk·4 = 0.5e9`` bytes of scores the exact path is one
    attention (the JAX package's values); above it, query chunks (as the
    JAX package's), with the same values."""
    from repro_torch.core import prism_attention as tpa
    jp, tp = _weights(3)
    rng = np.random.RandomState(4)
    q = rng.randn(1, 64, H, 24).astype(np.float32)
    c = rng.randn(1, 64, 24).astype(np.float32)
    pe = rng.randn(1, 64, 8).astype(np.float32)
    want = jx.exchange_attention_mla(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(pe), jp["w_uk"],
        jp["w_uv"], jx.ExchangeConfig(), causal=True, scale=0.2)
    calls = []
    real = tx.chunked_reference_attention

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)
    monkeypatch.setattr(tx, "chunked_reference_attention", spy)
    args = (tp["w_uk"], tp["w_uv"], tx.ExchangeConfig())
    got = tx.exchange_attention_mla(torch.from_numpy(q), torch.from_numpy(c),
                                    torch.from_numpy(pe), *args, causal=True,
                                    scale=0.2)
    assert not calls
    assert _diff(got.numpy(), want) <= TOL
    N = 8192                     # 4 · 8192² · 4 B > 0.5e9: 4 chunks
    qb = torch.from_numpy(rng.randn(1, N, H, 24).astype(np.float32))
    cb = torch.from_numpy(rng.randn(1, N, 24).astype(np.float32))
    pb = torch.from_numpy(rng.randn(1, N, 8).astype(np.float32))
    big = tx.exchange_attention_mla(qb, cb, pb, *args, causal=True,
                                    scale=0.2)
    assert len(calls) == 1
    k, v = tx._mla_expand(cb, pb, tp["w_uk"], tp["w_uv"])
    rows = tpa.reference_attention(qb[:, -8:], k, v, causal=True,
                                   q_offset=N - 8, scale=0.2)
    assert _diff(big[:, -8:].numpy(), rows.numpy()) <= TOL


def test_mla_prefill_writes_the_latent_cache():
    jp, tp = _weights(5)
    x = _x(2, 6, 6)
    jc = jmla.init_mla_cache(2, 9, JCFG, jnp.float32)
    tc = tmla.init_mla_cache(2, 9, TCFG, torch.float32)
    yj, jc = jmla.mla_prefill(jp, jnp.asarray(x), H, JCFG,
                              jx.ExchangeConfig(), jc)
    yt, tc = tmla.mla_prefill(tp, torch.from_numpy(x), H, TCFG,
                              tx.ExchangeConfig(), tc)
    assert _diff(yt.numpy(), yj) <= TOL
    for name in ("c_kv", "k_pe"):
        assert _diff(tc[name].numpy(), jc[name]) <= TOL


def test_mla_decode_steps_match_jax():
    """Each absorbed decode step from the JAX cache before it: the output
    within 1e-5, and the latent the step writes."""
    jp, tp = _weights(7)
    B, S = 2, 8
    xs = _x(B, S, 8)
    jc = jmla.init_mla_cache(B, S, JCFG, jnp.float32)
    for t in range(S):
        tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
        yj, jc = jmla.mla_decode(jp, jnp.asarray(xs[:, t:t + 1]), H, JCFG,
                                 jx.ExchangeConfig(), jc, t)
        yt, tc = tmla.mla_decode(tp, torch.from_numpy(xs[:, t:t + 1]), H,
                                 TCFG, tx.ExchangeConfig(), tc, t)
        assert _diff(yt.numpy(), yj) <= TOL
        for name in ("c_kv", "k_pe"):
            assert _diff(tc[name].numpy(), jc[name]) <= TOL


def test_mla_decode_with_one_position_a_row():
    """A ``[B]`` cache index: row b writes at its own position and attends
    its own prefix, as the JAX package's B 1 step on that row's cache; a
    position past the end writes the last slot (JAX's clamped update)."""
    jp, tp = _weights(9)
    S = 6
    lens = [0, 3, 5, 7]
    B = len(lens)
    rng = np.random.RandomState(10)
    caches = {k: rng.randn(B, S, v).astype(np.float32)
              for k, v in (("c_kv", 24), ("k_pe", 8))}
    x = _x(B, 1, 11)
    tc = {k: torch.from_numpy(v.copy()) for k, v in caches.items()}
    yt, tc = tmla.mla_decode(tp, torch.from_numpy(x), H, TCFG,
                             tx.ExchangeConfig(), tc, torch.tensor(lens))
    for b, n in enumerate(lens):
        jc = {k: jnp.asarray(v[b:b + 1]) for k, v in caches.items()}
        yj, jc = jmla.mla_decode(jp, jnp.asarray(x[b:b + 1]), H, JCFG,
                                 jx.ExchangeConfig(), jc, n)
        if n < S:
            assert _diff(yt[b:b + 1].numpy(), yj) <= TOL
        for name in ("c_kv", "k_pe"):
            assert _diff(tc[name][b:b + 1].numpy(), jc[name]) <= TOL


def test_mla_decode_attention_local_matches_jax():
    rng = np.random.RandomState(12)
    ql = rng.randn(3, 1, H, 24).astype(np.float32)
    qp = rng.randn(3, 1, H, 8).astype(np.float32)
    c = rng.randn(3, 10, 24).astype(np.float32)
    pe = rng.randn(3, 10, 8).astype(np.float32)
    for clen in (1, 7, 10):
        want = jx.mla_decode_attention_sharded(
            *(jnp.asarray(a) for a in (ql, qp, c, pe)), clen,
            jx.ExchangeConfig(), scale=0.2)
        got = tx.mla_decode_attention_sharded(
            *(torch.from_numpy(a) for a in (ql, qp, c, pe)), clen,
            tx.ExchangeConfig(), scale=0.2)
        assert got.shape == (3, 1, H, 24)
        assert _diff(got.numpy(), want) <= TOL


@pytest.mark.parametrize("part", [0, 1, 2])
def test_prism_kernel_plain_version_at_mla_widths(part):
    """The kernel wrapper on CPU tensors (its plain version) with keys 24
    wide and values 12, the means as the MLA exchange hands them over
    (``[B, P, L, H, ·]``), against the JAX package's ``prism_attention``."""
    from repro_torch.kernels import dispatch as kdsp
    rng = np.random.RandomState(13 + part)
    B, Np, P, L = 2, 8, 3, 2
    q = rng.randn(B, Np, H, 24).astype(np.float32)
    k = rng.randn(B, Np, H, 24).astype(np.float32)
    v = rng.randn(B, Np, H, 12).astype(np.float32)
    km = rng.randn(B, P, L, H, 24).astype(np.float32)
    vm = rng.randn(B, P, L, H, 12).astype(np.float32)
    want = jpa.prism_attention(*(jnp.asarray(a) for a in (q, k, v, km, vm)),
                               part, Np // L, causal=True, scale=0.2)
    got = kdsp.prism_attention(*(torch.from_numpy(a)
                                 for a in (q, k, v, km, vm)),
                               part, Np // L, causal=True, scale=0.2)
    assert got.shape == (B, Np, H, 12)
    assert _diff(got.numpy(), want) <= TOL
