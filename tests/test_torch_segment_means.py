"""Segment means in the port against the JAX package, in f32 on the CPU.

The same numpy inputs go through the JAX functions — the Pallas kernel in
interpret mode (``segment_means_op``, ``segment_means_pallas``), the core
reference and the dispatch layer's masked composition — and through the
port's plain version, op and dispatch, the K+V call among them.  Tolerance atol = rtol = 1e-5: both sides sum in f32 and differ
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
from repro.kernels.segment_means.kernel import segment_means_pallas
from repro_torch.kernels import dispatch as tdsp
from repro_torch.kernels.segment_means import (segment_means,
                                               segment_means_kv,
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
    got = segment_means(x.to("meta"), 2)       # the dry run's shape function
    assert [(t.shape, t.dtype, t.device.type) for t in got] == [
        ((1, 2, 4), torch.float32, "meta"), ((1, 2), torch.float32, "meta")]
    assert segment_means.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        segment_means(_on_xpu(x), 2)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("axis", [1, 2])
def test_kv_means_match_the_jax_package(axis, masked):
    """``segment_means_kv`` (K and V in one call) against the JAX package
    applied to K and V one at a time: the masked composition of
    ``dispatch.segment_means_masked`` (its Pallas path at axis 1, its
    reference elsewhere), or the Pallas kernel in interpret mode unmasked.
    Means to 1e-5, counts exact."""
    r = np.random.RandomState(20 + axis + 2 * masked)
    shape = (8, 100, 12, 64) if axis == 1 else (3, 4, 40, 24)
    L = 20 if axis == 1 else 8
    k, v = (r.randn(*shape).astype(np.float32) for _ in range(2))
    m = None
    if masked:
        m = r.rand(*shape[:axis + 1]) > 0.3
        m.reshape(-1, shape[axis])[0, : shape[axis] // L] = False
    means, counts = tdsp.segment_means_kv(
        torch.from_numpy(k), torch.from_numpy(v), L,
        None if m is None else torch.from_numpy(m), axis=axis)
    lead, seg = shape[:axis], shape[axis] // L
    assert tuple(means.shape) == (2, *lead, L, *shape[axis + 1:])
    assert tuple(counts.shape) == (*lead, L)
    for i, x in enumerate((k, v)):
        if masked:
            with jdsp.force_backend("pallas"):
                jm, jc = jdsp.segment_means_masked(jnp.asarray(x), L,
                                                   jnp.asarray(m), axis=axis)
            np.testing.assert_array_equal(np.asarray(jc), counts.numpy())
        else:
            flat = x.reshape(-1, shape[axis], int(np.prod(shape[axis + 1:])))
            D = flat.shape[-1]
            jm = np.asarray(segment_means_pallas(
                jnp.asarray(flat), L, block_d=128 if D % 128 == 0 else D,
                interpret=True)).reshape(means.shape[1:])
            assert (counts == seg).all()
        _close(jm, means[i])
    assert tdsp.backend_info()["segment_means"] == "reference"


def test_kv_call_on_the_cpu_counts_no_launch():
    """The K+V wrapper takes the plain version for CPU tensors (each input
    through ``segment_means_ref``, stacked) and raises for a device it has
    no kernel for."""
    r = np.random.RandomState(4)
    k, v = (torch.from_numpy(r.randn(2, 12, 10).astype(np.float32))
            for _ in range(2))
    mask = torch.from_numpy(r.rand(2, 12) > 0.5)
    before = segment_means.launches
    means, counts = segment_means_kv(k, v, 3, mask)
    assert segment_means.launches == before
    for i, x in enumerate((k, v)):
        want, want_c = segment_means_ref(x, 3, mask)
        assert torch.equal(means[i], want) and torch.equal(counts, want_c)
    got = segment_means_kv(k.to("meta"), v.to("meta"), 3)   # shape function
    assert [(t.shape, t.device.type) for t in got] == [
        (means.shape, "meta"), (counts.shape, "meta")]
    assert segment_means.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        segment_means_kv(_on_xpu(k), _on_xpu(v), 3)


def _on_xpu(t):
    """A stand-in for ``t`` on a device the port has no kernel for (only
    its ``device`` is read before the wrapper refuses it)."""
    import types
    return types.SimpleNamespace(device=torch.device("xpu"), shape=t.shape,
                                 dtype=t.dtype)


@pytest.mark.parametrize("Mp,pad", [(752, 4), (816, 31)])
def test_kv_means_over_a_padded_memory_block_match_the_jax_package(Mp, pad):
    """The cross-attention exchange's call: K and V of the memory's last
    block (whisper's 752 frames with 4 padding, the vision model's 816
    image tokens with 31), L 16, so the padding is a suffix of the last
    segment, against the JAX package's masked composition (its Pallas
    path): means to 1e-5, counts exact, the last segment's count the real
    tokens it holds."""
    r = np.random.RandomState(Mp)
    L = 16
    k, v = (r.randn(2, Mp, 24).astype(np.float32) for _ in range(2))
    m = np.repeat((np.arange(Mp) < Mp - pad)[None], 2, axis=0)
    means, counts = segment_means_kv(torch.from_numpy(k), torch.from_numpy(v),
                                     L, torch.from_numpy(m))
    assert (counts[:, -1] == Mp // L - pad).all()
    assert (counts[:, :-1] == Mp // L).all()
    for i, x in enumerate((k, v)):
        with jdsp.force_backend("pallas"):
            jm, jc = jdsp.segment_means_masked(jnp.asarray(x), L,
                                               jnp.asarray(m), axis=1)
        np.testing.assert_array_equal(np.asarray(jc), counts.numpy())
        _close(jm, means[i])
