"""Segment means in the port against the JAX package, in f32 on the CPU.

The same numpy inputs go through the JAX functions — the Pallas kernel in
interpret mode (``segment_means_op``), the core reference and the dispatch
layer's masked composition — and through the port's plain version, op and
dispatch.  Tolerance atol = rtol = 1e-5: both sides sum in f32 and differ
only in order.  The CUDA kernel itself is held against the plain version
on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import segment_means as jsm
from repro.kernels import dispatch as jdsp
from repro.kernels.segment_means import segment_means_op as jax_op
from repro_torch.kernels import dispatch as tdsp
from repro_torch.kernels.segment_means import (segment_means,
                                               segment_means_op,
                                               segment_means_ref)

TOL = dict(atol=1e-5, rtol=1e-5)


def _close(j, t):
    np.testing.assert_allclose(np.asarray(j, np.float32),
                               t.float().numpy(), **TOL)


def _mask(r, B, N, L):
    """Random padding with one segment of row 0 left wholly empty."""
    m = r.rand(B, N) > 0.3
    m[0, : N // L] = False
    return m


@pytest.mark.parametrize("B,N,feat,L", [(1, 16, (128,), 4),
                                        (2, 64, (48,), 8),
                                        (3, 33, (7,), 11),
                                        (2, 32, (4, 16), 8),
                                        (8, 100, (12, 64), 20)])
def test_unmasked_matches_the_pallas_kernel(B, N, feat, L):
    x = np.random.RandomState(N).randn(B, N, *feat).astype(np.float32)
    means, counts = segment_means_op(torch.from_numpy(x), L)
    _close(jax_op(jnp.asarray(x), L, interpret=True), means)
    assert torch.equal(counts, torch.full((B, L), float(N // L)))


@pytest.mark.parametrize("B,N,feat,L", [(2, 24, (16,), 4),
                                        (3, 40, (2, 8), 5),
                                        (8, 100, (12, 64), 20)])
def test_masked_matches_the_jax_reference_and_composition(B, N, feat, L):
    r = np.random.RandomState(B * N)
    x = r.randn(B, N, *feat).astype(np.float32)
    m = _mask(r, B, N, L)
    means, counts = segment_means_op(torch.from_numpy(x), L,
                                     torch.from_numpy(m))
    jm, jc = jsm.segment_means_masked(jnp.asarray(x), L, jnp.asarray(m),
                                      axis=1)
    _close(jm, means)
    _close(jc, counts)
    assert counts[0, 0] == 0 and (means[0, 0] == 0).all()  # empty segment
    with jdsp.force_backend("pallas"):       # the JAX kernel + composition
        km, kc = jdsp.segment_means_masked(jnp.asarray(x), L,
                                           jnp.asarray(m), axis=1)
    _close(km, means)
    _close(kc, counts)


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
def test_dispatch_takes_any_segment_axis(axis):
    r = np.random.RandomState(5)
    x = r.randn(6, 12, 10, 4).astype(np.float32)
    L = {0: 3, 1: 4, 2: 5, -1: 2}[axis]
    ax = axis % x.ndim
    m = r.rand(*x.shape[:ax + 1]) > 0.4
    _close(jsm.segment_means(jnp.asarray(x), L, axis=axis),
           tdsp.segment_means(torch.from_numpy(x), L, axis=axis))
    jm, jc = jsm.segment_means_masked(jnp.asarray(x), L, jnp.asarray(m),
                                      axis=axis)
    tm, tc = tdsp.segment_means_masked(torch.from_numpy(x), L,
                                       torch.from_numpy(m), axis=axis)
    assert tuple(tm.shape) == jm.shape and tuple(tc.shape) == jc.shape
    _close(jm, tm)
    _close(jc, tc)
    assert tdsp.backend_info()["segment_means"] == "reference"


def test_bf16_keeps_the_dtype_and_sums_in_f32():
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 40, 64)
                         .astype(np.float32)).to(torch.bfloat16)
    means, counts = segment_means_ref(x, 8)
    want = x.float().reshape(2, 8, 5, 64).mean(2).to(torch.bfloat16)
    assert means.dtype == torch.bfloat16 and counts.dtype == torch.float32
    assert torch.equal(means, want)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = segment_means.launches
    x = torch.ones(1, 8, 4)
    assert torch.equal(segment_means(x, 2)[0], torch.ones(1, 2, 4))
    assert segment_means.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        segment_means(x.to("meta"), 2)
