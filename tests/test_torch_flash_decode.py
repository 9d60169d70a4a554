"""The port's flash-decode: its plain version against the JAX package's
oracle and Pallas kernel (interpret mode, as ``tests/test_kernels.py`` runs
it on the CPU), and the op/dispatch plumbing around it.  The CUDA kernel
itself is held against the plain version in ``test_torch_gpu.py``.

Tolerances: f32 partials agree to atol = rtol = 2e-5 (same f32 math,
different summation order; ``l`` sums up to S terms of order 1).  Masked
rows keep ``m = -1e30`` exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode_ref as j_ref
from repro.kernels.flash_decode.kernel import flash_decode_pallas
from repro.kernels.flash_decode.ops import merge_partials as j_merge
from repro.kernels.flash_decode.ops import pick_s_block as j_pick
from repro.kernels.flash_decode.ops import validity_bias as j_bias
from repro_torch.kernels import dispatch as kdsp
from repro_torch.kernels.flash_decode import (flash_decode, flash_decode_op,
                                              flash_decode_ref,
                                              merge_partials, validity_bias,
                                              validity_mask)
from repro_torch.kernels.flash_decode.ops import pick_s_block

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, B, S, H, Hk, dh):
    r = np.random.RandomState(seed)
    return (r.randn(B, H, dh).astype(np.float32),
            r.randn(B, S, Hk, dh).astype(np.float32),
            r.randn(B, S, Hk, dh).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(j, t, **tol):
    np.testing.assert_allclose(np.asarray(j, np.float32), t.numpy(),
                               **(tol or TOL))


# (B, S, H, Hk, dh, cache_len, offset, window, softcap)
CASES = [
    (2, 48, 4, 4, 16, [48, 7], 0, None, None),      # GQA group 1, S % 32
    (3, 40, 8, 2, 16, [1, 23, 40], 0, None, None),  # group 4, S not pow2
    (2, 37, 4, 1, 32, [37, 12], 0, None, 30.0),     # softcap, prime S
    (2, 64, 4, 2, 16, [50, 64], 0, 16, None),       # sliding window
    (2, 32, 4, 2, 16, [40, 70], 16, None, None),    # shard offset
    (2, 24, 4, 2, 16, [0, 9], 0, None, None),       # row 0 fully masked
]


@pytest.mark.parametrize("B,S,H,Hk,dh,clen,offset,window,softcap", CASES)
def test_plain_version_matches_jax_ref_and_pallas(B, S, H, Hk, dh, clen,
                                                  offset, window, softcap):
    q, k, v = _inputs(B * S + H, B, S, H, Hk, dh)
    clen = np.asarray(clen, np.int32)
    bj = j_bias(B, S, jnp.asarray(clen), offset=offset, window=window)
    bt = validity_bias(B, S, torch.from_numpy(clen), offset=offset,
                       window=window)
    np.testing.assert_array_equal(np.asarray(bj), bt.numpy())
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref = j_ref(jq, jk, jv, bj, softcap=softcap)
    pallas = flash_decode_pallas(jq, jk, jv, bj, softcap=softcap,
                                 s_block=j_pick(S), interpret=True)
    tq, tk, tv = _t(q, k, v)
    ours = flash_decode_ref(tq, tk, tv, bt, softcap=softcap)
    for want in (ref, pallas):
        for a, b in zip(want, ours):
            _close(a, b)
    # the wrapper's CPU route is the plain version, bit for bit
    for a, b in zip(ours, flash_decode_op(tq, tk, tv, torch.from_numpy(clen),
                                          offset=offset, window=window,
                                          softcap=softcap)):
        assert torch.equal(a, b)
    masked = ~validity_mask(B, S, torch.from_numpy(clen), offset=offset,
                            window=window).any(dim=1)
    if masked.any():                  # fully masked rows: m = -1e30, l = S
        assert (ours[1][masked] == -1e30).all()
        assert (ours[2][masked] == S).all()


def test_merge_partials_matches_jax():
    r = np.random.RandomState(3)
    o = r.randn(3, 2, 4, 8).astype(np.float32)
    m = r.randn(3, 2, 4).astype(np.float32)
    l = r.rand(3, 2, 4).astype(np.float32) + 0.5
    _close(j_merge(*map(jnp.asarray, (o, m, l))), merge_partials(*_t(o, m, l)))


def test_sharded_partials_merge_to_full_attention():
    from repro_torch.core.prism_attention import reference_attention
    q, k, v = _t(*_inputs(5, 2, 64, 4, 2, 16))
    clen = torch.tensor([40, 64])
    parts = [flash_decode_op(q, k[:, i * 16:(i + 1) * 16],
                             v[:, i * 16:(i + 1) * 16], clen, offset=i * 16)
             for i in range(4)]
    merged = merge_partials(*(torch.stack(p) for p in zip(*parts)))
    full = reference_attention(q[:, None], k, v,
                               kv_mask=torch.arange(64)[None] < clen[:, None])
    torch.testing.assert_close(merged, full[:, 0], atol=3e-5, rtol=3e-5)


def test_pick_s_block_matches_jax():
    for S in (1, 24, 48, 96, 512, 1536, 2047, 2048, 4100):
        assert pick_s_block(S) == j_pick(S)


def test_dispatch_routes_cpu_tensors_to_plain_version():
    q, k, v = _t(*_inputs(7, 2, 16, 4, 2, 16))
    before = flash_decode.launches
    out = kdsp.decode_attention(q[:, None], k, v, torch.tensor([16, 5]))
    assert out.shape == (2, 1, 4, 16)
    assert kdsp.backend_info()["decode_attention"] == "reference"
    assert flash_decode.launches == before       # no kernel launch on CPU


def _bad_inputs(what):
    q, k, v = _t(*_inputs(9, 2, 16, 8, 2, 64))
    bias = torch.zeros(2, 16)
    if what == "head_dim":
        q, k, v = q[..., :48].contiguous(), k[..., :48].contiguous(), \
            v[..., :48].contiguous()
    elif what == "group":
        q = torch.zeros(2, 24, 64)                   # 12 query heads per KV
    elif what == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif what == "mixed_dtype":
        k = k.to(torch.bfloat16)
    elif what == "bias_dtype":
        bias = bias.double()
    elif what == "bias_shape":
        bias = torch.zeros(2, 15)
    elif what == "contiguity":
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    return q, k, v, bias


@pytest.mark.parametrize("what,exc", [
    ("head_dim", ValueError), ("group", ValueError), ("dtype", TypeError),
    ("mixed_dtype", TypeError), ("bias_dtype", TypeError),
    ("bias_shape", ValueError), ("contiguity", ValueError)])
def test_kernel_checks_refuse_what_the_kernel_does_not_take(what, exc):
    """The checks the wrapper runs before a CUDA launch (device-independent,
    so they run here on CPU tensors)."""
    from repro_torch.kernels.flash_decode.kernel import _check
    _check(*_bad_inputs(None))                      # the good case passes
    with pytest.raises(exc, match="flash_decode"):
        _check(*_bad_inputs(what))


def test_wrapper_refuses_devices_without_a_kernel():
    q, k, v = (t.to("meta") for t in _t(*_inputs(8, 1, 8, 2, 2, 64)))
    bias = torch.zeros(1, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_decode(q, k, v, bias)
