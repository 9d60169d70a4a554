"""Module parity of the PyTorch port against the JAX package, in f32.

Every test feeds the same numpy inputs (from a seed) to the JAX function
and its counterpart in ``repro_torch`` and compares the outputs.  Unless a
test says otherwise the tolerance is atol = rtol = 1e-5: both sides compute
in f32 and differ only in summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partition as jpart
from repro.core import prism_attention as jpa
from repro.core import segment_means as jsm
from repro.models import layers as jl
from repro_torch.core import partition as tpart
from repro_torch.core import prism_attention as tpa
from repro_torch.core import segment_means as tsm
from repro_torch.models import layers as tl

TOL = dict(atol=1e-5, rtol=1e-5)


def _rng(seed=0):
    return np.random.RandomState(seed)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.asarray(a))


def _close(j, t, **tol):
    np.testing.assert_allclose(np.asarray(j, np.float32),
                               t.detach().float().numpy(), **(tol or TOL))


def test_rmsnorm_and_layernorm():
    r = _rng(1)
    x = r.randn(2, 5, 32).astype(np.float32) * 3
    scale = r.randn(32).astype(np.float32) * 0.1
    bias = r.randn(32).astype(np.float32) * 0.1
    xj, xt = _both(x)
    _close(jl.rmsnorm({"scale": jnp.asarray(scale)}, xj),
           tl.rmsnorm({"scale": torch.from_numpy(scale)}, xt))
    _close(jl.layernorm({"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}, xj),
           tl.layernorm({"scale": torch.from_numpy(scale),
                         "bias": torch.from_numpy(bias)}, xt))


def test_rope_tables_and_apply():
    r = _rng(2)
    pos = r.randint(0, 4096, size=(2, 7)).astype(np.int32)
    x = r.randn(2, 7, 3, 16).astype(np.float32)
    cj, sj = jl.rope_tables(jnp.asarray(pos), 16, 500_000.0)
    ct, st = tl.rope_tables(torch.from_numpy(pos), 16, 500_000.0)
    # angles reach ~4e3 rad: f32 cos/sin of the same angle agree to ~1e-4
    _close(cj, ct, atol=2e-4, rtol=0)
    _close(sj, st, atol=2e-4, rtol=0)
    _close(jl.apply_rope(jnp.asarray(x), cj, sj),
           tl.apply_rope(torch.from_numpy(x), torch.tensor(np.asarray(cj)),
                         torch.tensor(np.asarray(sj))))


@pytest.mark.parametrize("Hk", [4, 2])
def test_project_qkv(Hk):
    r = _rng(3)
    D, H, hd = 32, 4, 8
    p = {"wq": r.randn(D, H * hd), "wk": r.randn(D, Hk * hd),
         "wv": r.randn(D, Hk * hd)}
    p = {k: (v * D ** -0.5).astype(np.float32) for k, v in p.items()}
    x = r.randn(2, 6, D).astype(np.float32)
    spec_j = jl.AttnSpec(n_heads=H, n_kv=Hk, head_dim=hd, rope_theta=1e4)
    spec_t = tl.AttnSpec(n_heads=H, n_kv=Hk, head_dim=hd, rope_theta=1e4)
    outs_j = jl.project_qkv({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), spec_j, None)
    outs_t = tl.project_qkv({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), spec_t, None)
    for a, b in zip(outs_j, outs_t):
        _close(a, b)


def test_apply_mlp_silu_and_gelu():
    r = _rng(4)
    p = {"w_up": r.randn(16, 32), "w_gate": r.randn(16, 32),
         "w_down": r.randn(32, 16)}
    p = {k: (v * 0.2).astype(np.float32) for k, v in p.items()}
    x = r.randn(2, 3, 16).astype(np.float32)
    for act, keys in (("silu", p), ("gelu", {k: p[k] for k in
                                             ("w_up", "w_down")})):
        _close(jl.apply_mlp({k: jnp.asarray(v) for k, v in keys.items()},
                            jnp.asarray(x), act),
               tl.apply_mlp({k: torch.from_numpy(v) for k, v in keys.items()},
                            torch.from_numpy(x), act))


@pytest.mark.parametrize("H,Hk,causal,window,softcap",
                         [(4, 4, False, None, None), (4, 2, True, None, None),
                          (8, 2, True, 5, 30.0), (4, 1, False, None, 20.0)])
def test_reference_attention(H, Hk, causal, window, softcap):
    r = _rng(5)
    q = r.randn(2, 12, H, 8).astype(np.float32)
    k = r.randn(2, 12, Hk, 8).astype(np.float32)
    v = r.randn(2, 12, Hk, 8).astype(np.float32)
    mask = r.rand(2, 12) > 0.3
    mask[1] = False                   # fully masked row: uniform, not NaN
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    oj = jpa.reference_attention(*map(jnp.asarray, (q, k, v)),
                                 kv_mask=jnp.asarray(mask), **kw)
    ot = tpa.reference_attention(*map(torch.from_numpy, (q, k, v)),
                                 kv_mask=torch.from_numpy(mask), **kw)
    assert torch.isfinite(ot).all()
    _close(oj, ot)


def test_chunked_reference_attention():
    r = _rng(6)
    q = r.randn(1, 32, 4, 8).astype(np.float32)
    k = r.randn(1, 32, 2, 8).astype(np.float32)
    v = r.randn(1, 32, 2, 8).astype(np.float32)
    oj = jpa.chunked_reference_attention(*map(jnp.asarray, (q, k, v)),
                                         chunk=8, causal=True, q_offset=3)
    ot = tpa.chunked_reference_attention(*map(torch.from_numpy, (q, k, v)),
                                         chunk=8, causal=True, q_offset=3)
    _close(oj, ot)
    # the chunked walk is the unchunked oracle, exactly
    full = tpa.reference_attention(*map(torch.from_numpy, (q, k, v)),
                                   causal=True, q_offset=3)
    _close(np.asarray(full), ot)


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (False, True)])
def test_prism_attention(causal, masked):
    r = _rng(7)
    B, Np, H, Hk, dh, P, L = 2, 8, 4, 2, 8, 3, 2
    q = r.randn(B, Np, H, dh).astype(np.float32)
    kl = r.randn(B, Np, Hk, dh).astype(np.float32)
    vl = r.randn(B, Np, Hk, dh).astype(np.float32)
    km = r.randn(B, P, L, Hk, dh).astype(np.float32)
    vm = r.randn(B, P, L, Hk, dh).astype(np.float32)
    kw = dict(causal=causal, logit_softcap=25.0)
    if masked:
        kw_j = dict(kv_mask=jnp.asarray(r.rand(B, Np) > 0.2),
                    mean_counts=jnp.asarray(
                        r.randint(0, 4, (B, P, L)).astype(np.float32)))
        kw_t = {k: torch.tensor(np.asarray(v)) for k, v in kw_j.items()}
    else:
        kw_j = kw_t = {}
    oj = jpa.prism_attention(*map(jnp.asarray, (q, kl, vl, km, vm)), 1, 4,
                             **kw, **kw_j)
    ot = tpa.prism_attention(*map(torch.from_numpy, (q, kl, vl, km, vm)), 1,
                             4, **kw, **kw_t)
    _close(oj, ot)


@pytest.mark.parametrize("causal", [False, True])
def test_simulate_prism_and_voltage(causal):
    r = _rng(8)
    B, N, H, Hk, dh, P, L = 2, 16, 4, 2, 8, 2, 4
    q = r.randn(B, N, H, dh).astype(np.float32)
    k = r.randn(B, N, Hk, dh).astype(np.float32)
    v = r.randn(B, N, Hk, dh).astype(np.float32)
    _close(jpart.simulate_prism_attention(*map(jnp.asarray, (q, k, v)), P, L,
                                          causal=causal),
           tpart.simulate_prism_attention(*map(torch.from_numpy, (q, k, v)),
                                          P, L, causal=causal))
    _close(jpart.simulate_voltage_attention(*map(jnp.asarray, (q, k, v)), P,
                                            causal=causal),
           tpart.simulate_voltage_attention(*map(torch.from_numpy, (q, k, v)),
                                            P, causal=causal))
    parts = tpart.partition_sequence(torch.from_numpy(q), P)
    assert torch.equal(tpart.unpartition_sequence(parts),
                       torch.from_numpy(q))


def test_segment_means_and_masked():
    r = _rng(9)
    x = r.randn(2, 12, 3, 4).astype(np.float32)
    mask = r.rand(2, 12) > 0.4
    _close(jsm.segment_means(jnp.asarray(x), 3, axis=1),
           tsm.segment_means(torch.from_numpy(x), 3, axis=1))
    mj, cj = jsm.segment_means_masked(jnp.asarray(x), 4, jnp.asarray(mask),
                                      axis=1)
    mt, ct = tsm.segment_means_masked(torch.from_numpy(x), 4,
                                      torch.from_numpy(mask), axis=1)
    _close(mj, mt)
    _close(cj, ct)
    for n, P, cr in ((197, 2, 4.95), (32, 2, 9.9), (64, 4, 3.3)):
        assert tsm.cr_to_L(n, P, cr) == jsm.cr_to_L(n, P, cr)
        L = tsm.cr_to_L(n, P, cr)
        assert tsm.L_to_cr(n, P, L) == jsm.L_to_cr(n, P, L)
    with pytest.raises(ValueError):
        tsm.segment_means(torch.zeros(1, 10, 2), 3, axis=1)


def test_int8_kv_quantizer():
    r = _rng(10)
    t = (r.randn(2, 5, 3, 16) * 4).astype(np.float32)
    qj, sj = jl._quantize_kv(jnp.asarray(t))
    qt, st = tl._quantize_kv(torch.from_numpy(t))
    np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
    _close(sj, st)
    _close(jl._dequantize_kv(qj, sj, jnp.float32),
           tl._dequantize_kv(qt, st, torch.float32))


def test_embed_unembed_tied():
    r = _rng(11)
    table = (r.randn(40, 8) * 0.02).astype(np.float32)
    tok = r.randint(0, 40, size=(2, 5))
    xj = jl.embed({"table": jnp.asarray(table)}, jnp.asarray(tok))
    xt = tl.embed({"table": torch.from_numpy(table)}, torch.from_numpy(tok))
    _close(xj, xt)
    _close(jl.unembed({"table": jnp.asarray(table)}, xj, final_softcap=5.0),
           tl.unembed({"table": torch.from_numpy(table)}, xt,
                      final_softcap=5.0))


def test_bridge_carries_bf16_bit_for_bit():
    from repro_torch.models.bridge import tensor_from_numpy
    a = np.asarray(jnp.asarray(_rng(12).randn(3, 5), jnp.bfloat16))
    t = tensor_from_numpy(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))
    _close(jax.device_get(jnp.asarray(a, jnp.float32)), t, atol=0, rtol=0)
