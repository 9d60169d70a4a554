"""PRISM attention in the port against the JAX package, in f32 on the CPU.

The same numpy inputs go through the JAX functions — the Pallas kernel in
interpret mode (``prism_attention_op``, which takes no key mask), its plain
version and the core ``prism_attention`` — and through the port's op,
plain version and dispatch.  Tolerance atol = rtol = 1e-5: both sides
compute the softmax in f32 and differ only in summation order.  The CUDA
kernel itself is held against the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prism_attention as jpa
from repro.kernels.prism_attention import ops as jops
from repro.kernels.prism_attention import prism_attention_ref as jax_ref
from repro.kernels.prism_attention.kernel import prism_attention_pallas
from repro_torch.kernels import dispatch as tdsp
from repro_torch.kernels.prism_attention import (build_mean_bias,
                                                 prism_attention,
                                                 prism_attention_op,
                                                 prism_attention_ref)

TOL = dict(atol=1e-5, rtol=1e-5)


def _close(j, t):
    np.testing.assert_allclose(np.asarray(j, np.float32),
                               t.float().numpy(), **TOL)


def _inputs(seed, B, Nq, H, Hk, dh, P, L):
    r = np.random.RandomState(seed)
    f = np.float32
    return (r.randn(B, Nq, H, dh).astype(f), r.randn(B, Nq, Hk, dh).astype(f),
            r.randn(B, Nq, Hk, dh).astype(f),
            r.randn(B, P, L, Hk, dh).astype(f),
            r.randn(B, P, L, Hk, dh).astype(f))


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("B,Nq,H,Hk,dh,P,L", [(1, 16, 2, 2, 8, 2, 2),
                                              (2, 32, 4, 2, 16, 4, 4),
                                              (1, 128, 8, 8, 64, 2, 8),
                                              (1, 24, 6, 2, 32, 3, 2)])
@pytest.mark.parametrize("causal", [False, True])
def test_op_matches_the_pallas_kernel(B, Nq, H, Hk, dh, P, L, causal):
    arrs = _inputs(Nq + H, B, Nq, H, Hk, dh, P, L)
    pidx = P // 2
    want = jops.prism_attention_op(*map(jnp.asarray, arrs), pidx,
                                   seg_size=4, causal=causal, interpret=True)
    got = prism_attention_op(*_t(arrs), pidx, seg_size=4, causal=causal)
    _close(want, got)


def test_softcap_matches_the_pallas_kernel():
    q, kl, vl, km, vm = _inputs(9, 2, 32, 4, 2, 16, 2, 4)
    bias = jops.build_mean_bias(2, 2, 4, 1, 4, causal=True)
    want = prism_attention_pallas(
        *map(jnp.asarray, (q, kl, vl, km.reshape(2, 8, 2, 16),
                           vm.reshape(2, 8, 2, 16))), bias, causal=True,
        softcap=5.0, q_block=16, interpret=True)
    got = prism_attention_op(*_t((q, kl, vl, km, vm)), 1, seg_size=4,
                             causal=True, softcap=5.0)
    _close(want, got)


@pytest.mark.parametrize("causal", [False, True])
def test_mean_bias_matches_the_jax_one(causal):
    counts = np.random.RandomState(2).randint(0, 4, size=(3, 4, 5))
    for pidx in range(4):
        _close(jops.build_mean_bias(3, 4, 5, pidx, 4, causal=causal),
               build_mean_bias(3, 4, 5, pidx, 4, causal=causal))
        _close(jops.build_mean_bias(3, 4, 5, pidx, 4, causal=causal,
                                    mean_counts=jnp.asarray(counts)),
               build_mean_bias(3, 4, 5, pidx, 4, causal=causal,
                               mean_counts=torch.from_numpy(counts)))


def test_plain_version_matches_the_jax_one():
    q, kl, vl, km, vm = _inputs(4, 2, 20, 4, 2, 16, 3, 2)
    bias = jops.build_mean_bias(2, 3, 2, 1, 5, causal=True)
    flat = (km.reshape(2, 6, 2, 16), vm.reshape(2, 6, 2, 16))
    want = jax_ref(*map(jnp.asarray, (q, kl, vl) + flat), bias, causal=True,
                   logit_softcap=30.0)
    got = prism_attention_ref(*_t((q, kl, vl) + flat),
                              torch.from_numpy(np.array(bias)), causal=True,
                              logit_softcap=30.0)
    _close(want, got)


@pytest.mark.parametrize("causal,softcap,Hk", [(False, None, 4),
                                               (True, None, 2),
                                               (False, 20.0, 1)])
def test_key_mask_and_counts_match_the_core_reference(causal, softcap, Hk):
    """The case the Pallas kernel refuses (masked local keys, per-segment
    counts with empty segments): the port's op against the JAX package's
    core ``prism_attention``, for every partition index."""
    B, Np, H, dh, P, L = 3, 20, 4, 16, 3, 4
    q, kl, vl, km, vm = _inputs(11, B, Np, H, Hk, dh, P, L)
    r = np.random.RandomState(12)
    mask = r.rand(B, Np) > 0.25
    mask[1, :] = False                                 # a fully masked row
    counts = r.randint(0, 6, size=(B, P, L)).astype(np.float32)
    counts[1] = 0.0
    for pidx in range(P):
        want = jpa.prism_attention(
            *map(jnp.asarray, (q, kl, vl, km, vm)), pidx, 5, causal=causal,
            logit_softcap=softcap, kv_mask=jnp.asarray(mask),
            mean_counts=jnp.asarray(counts))
        got = prism_attention_op(
            *_t((q, kl, vl, km, vm)), pidx, 5, causal=causal,
            softcap=softcap, kv_mask=torch.from_numpy(mask),
            mean_counts=torch.from_numpy(counts))
        _close(want, got)
        # row 1 sees no key at all: uniform weights over all Np + P·L
        # keys, as in the plain version (the Pallas kernel's clamp of its
        # running max at -1e29 would give 0/0 there)
        uniform = torch.cat([torch.from_numpy(vl[1]),
                             torch.from_numpy(vm[1].reshape(P * L, Hk, dh))]
                            ).mean(0)
        expect = uniform.repeat_interleave(H // Hk, dim=0)
        torch.testing.assert_close(got[1], expect.expand_as(got[1]),
                                   **TOL)


def test_dispatch_with_query_offset_matches_the_core_reference():
    q, kl, vl, km, vm = _inputs(13, 2, 16, 4, 2, 16, 2, 4)
    mask = np.random.RandomState(14).rand(2, 16) > 0.2
    for off in (0, 8):
        want = jpa.prism_attention(
            *map(jnp.asarray, (q[:, off:off + 8], kl, vl, km, vm)), 1, 4,
            causal=True, kv_mask=jnp.asarray(mask), q_offset=off)
        got = tdsp.prism_attention(
            *_t((q[:, off:off + 8], kl, vl, km, vm)), 1, 4, causal=True,
            kv_mask=torch.from_numpy(mask), q_offset=off)
        _close(want, got)
    assert tdsp.backend_info()["prism_attention"] == "reference"


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    q, kl, vl, km, vm = _t(_inputs(15, 1, 8, 2, 2, 8, 2, 2))
    bias = build_mean_bias(1, 2, 2, 0, 4, causal=False)
    before = prism_attention.launches
    out = prism_attention(q, kl, vl, km.reshape(1, 4, 2, 8),
                          vm.reshape(1, 4, 2, 8), bias, causal=False)
    assert out.shape == q.shape and prism_attention.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        prism_attention(q.to("meta"), kl, vl, km, vm, bias)
