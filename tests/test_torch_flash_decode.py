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
from repro_torch.kernels.flash_decode.kernel import (MAX_SPLITS, split_plan,
                                                     tile_size)
from repro_torch.kernels.flash_decode.ops import pick_s_block

from _hypothesis_fallback import given, settings, st

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
    """A device with no kernel raises; a meta tensor takes the kernel's
    shape function (the dry run: o, m, l f32 of the kernel's shapes, no
    launch)."""
    q, k, v = (t.to("meta") for t in _t(*_inputs(8, 1, 8, 2, 2, 64)))
    bias = torch.zeros(1, 8, device="meta")
    before = flash_decode.launches
    o, m, l = flash_decode(q, k, v, bias)
    B, H, dh = q.shape
    assert [(tuple(t.shape), t.dtype, t.device.type) for t in (o, m, l)] == [
        ((B, H, dh), torch.float32, "meta"), ((B, H), torch.float32, "meta"),
        ((B, H), torch.float32, "meta")]
    assert flash_decode.launches == before
    import types
    with pytest.raises(ValueError, match="no kernel"):
        flash_decode(types.SimpleNamespace(device=torch.device("xpu")), k,
                     v, bias)


# ---------------------------------------------------------------------------
# The split algebra the CUDA kernel relies on, in the plain math
# ---------------------------------------------------------------------------

def split_merge(q, k, v, bias, *, splits, tile, softcap=None):
    """What the kernel computes, step by step in the plain version: S cut
    into ``splits`` runs of whole tiles of ``tile`` positions (split i gets
    tiles ``[i·per, (i+1)·per)``, ``per = ceil(tiles / splits)``); in a row
    with a valid position (bias > -1e30) a tile with none is not read, and
    a split with no tile left is the identity (o = 0, m = -1e30, l = 0);
    each split's partial is ``flash_decode_ref`` over its tiles; the
    partials merge un-normalised: m = max m_i, l = Σ e^{m_i - m} l_i,
    o = Σ e^{m_i - m} o_i.  → (o, m, l, tiles skipped)."""
    B, H, dh = q.shape
    S = bias.shape[1]
    tiles = -(-S // tile)
    per = -(-tiles // splits)
    outs, skipped = [], 0
    for b in range(B):
        valid = bias[b] > -1e30
        live = bool(valid.any())
        parts = []
        for i in range(splits):
            kept = [t for t in range(i * per, min(tiles, (i + 1) * per))
                    if not live or valid[t * tile:(t + 1) * tile].any()]
            skipped += min(tiles, (i + 1) * per) - i * per - len(kept)
            if not kept:
                parts.append((torch.zeros(H, dh), torch.full((H,), -1e30),
                              torch.zeros(H)))
                continue
            pos = torch.cat([torch.arange(t * tile, min(S, (t + 1) * tile))
                             for t in kept])
            o, m, l = flash_decode_ref(q[b:b + 1], k[b:b + 1, pos],
                                       v[b:b + 1, pos], bias[b:b + 1, pos],
                                       softcap=softcap)
            parts.append((o[0], m[0], l[0]))
        o_i, m_i, l_i = (torch.stack(x) for x in zip(*parts))
        m = m_i.amax(dim=0)
        w = torch.exp(m_i - m)
        outs.append(((w[..., None] * o_i).sum(dim=0), m,
                     (w * l_i).sum(dim=0)))
    o, m, l = (torch.stack(x) for x in zip(*outs))
    return o, m, l, skipped


# (B, S, H, Hk, dh, cache_len, window, softcap, tile, n_sm, skips)
SPLIT_CASES = [
    (2, 37, 4, 2, 16, [37, 5], None, None, 8, 16, True),   # S % tile != 0
    (1, 48, 4, 2, 16, [30], None, None, 8, 64, True),      # one tile a split
    (2, 64, 4, 2, 16, [50, 64], 16, None, 8, 32, True),    # window: heads
    (2, 40, 8, 2, 32, [40, 17], None, 30.0, 16, 8, True),  # softcap
    (3, 24, 4, 2, 16, [0, 9, 24], None, None, 8, 12, True),  # row 0 masked
    (2, 45, 4, 4, 16, [45, 1], 8, 20.0, 8, 64, True),      # length 1, window
    (2, 16, 4, 1, 16, [0, 0], None, None, 8, 64, False),   # all masked
]


@pytest.mark.parametrize("B,S,H,Hk,dh,clen,window,softcap,tile,n_sm,skips",
                         SPLIT_CASES)
def test_split_partials_merge_to_the_jax_kernel(B, S, H, Hk, dh, clen,
                                                window, softcap, tile, n_sm,
                                                skips):
    """S cut as ``split_plan`` cuts it, masked tiles of live rows skipped,
    the partials merged un-normalised: the JAX package's reference and its
    Pallas kernel (interpret mode) within 1e-5 in f32.  Fully masked rows:
    m = -1e30 and l = S exactly, o = Σ v."""
    splits = split_plan(B, Hk, S, n_sm, tile)
    assert splits > 1
    q, k, v = _inputs(S + 7 * B, B, S, H, Hk, dh)
    clen = np.asarray(clen, np.int32)
    bj = j_bias(B, S, jnp.asarray(clen), window=window)
    tq, tk, tv, tb = _t(q, k, v, bj)
    o, m, l, skipped = split_merge(tq, tk, tv, tb, splits=splits, tile=tile,
                                   softcap=softcap)
    assert (skipped > 0) == skips
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref = j_ref(jq, jk, jv, bj, softcap=softcap)
    pallas = flash_decode_pallas(jq, jk, jv, bj, softcap=softcap,
                                 s_block=j_pick(S), interpret=True)
    for want in (ref, pallas):
        for a, b in zip(want, (o, m, l)):
            _close(a, b, atol=1e-5, rtol=1e-5)
    dead = torch.from_numpy(clen == 0)
    if dead.any():
        assert (m[dead] == -1e30).all() and (l[dead] == S).all()
        sum_v = tv.sum(dim=1).repeat_interleave(H // Hk, dim=1)
        _close(sum_v[dead].numpy(), o[dead], atol=1e-5, rtol=1e-5)


def test_tile_size_matches_the_cuda_source():
    """128 positions in bf16 (16 per warp for the tensor cores); a 16 KB K
    tile in f32."""
    assert tile_size(torch.bfloat16, 64) == tile_size(torch.bfloat16,
                                                      128) == 128
    assert tile_size(torch.float32, 64) == 64
    assert tile_size(torch.float32, 128) == 32


def test_split_plan_keeps_the_main_shape_one_launch():
    """``generate``'s shape (B 4, S 48, 8 KV heads, bf16) on 132 SMs is one
    CTA per (row, head) with no merge; batch 1 at S 2048 is split."""
    assert split_plan(4, 8, 48, 132, tile_size(torch.bfloat16, 64)) == 1
    assert split_plan(1, 8, 2048, 132, 128) == MAX_SPLITS == 8
    assert split_plan(8, 8, 2048, 132, 128) == 2
    assert split_plan(16, 8, 8192, 132, 128) == 1      # B·Hk fills half


@given(st.integers(1, 40), st.integers(1, 16), st.integers(1, 20000),
       st.integers(1, 264), st.integers(0, 2))
@settings(deadline=None, max_examples=200)
def test_split_plan_properties(B, Hk, S, n_sm, which):
    """Whole tiles, every tile in exactly one non-empty split, at most one
    cluster's worth of splits, one split where B·Hk fills half the SMs or
    S fits a tile, and B·Hk·splits within one wave and at least half of
    what the cap and the tiles allow of it."""
    tile = (32, 64, 128)[which]
    splits = split_plan(B, Hk, S, n_sm, tile)
    tiles = -(-S // tile)
    per = -(-tiles // splits)
    ranges = [range(i * per, min(tiles, (i + 1) * per))
              for i in range(splits)]
    assert all(len(r) > 0 for r in ranges)
    assert sorted(t for r in ranges for t in r) == list(range(tiles))
    ctas = B * Hk
    assert 1 <= splits <= MAX_SPLITS
    if 2 * ctas > n_sm or tiles == 1:
        assert splits == 1
    else:
        assert splits <= tiles
        assert ctas * splits <= n_sm
        want = min(tiles, MAX_SPLITS, n_sm // ctas)
        assert 2 * splits >= want
