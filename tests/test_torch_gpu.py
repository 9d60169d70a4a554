"""Tests that need a CUDA card (marker ``gpu``); they skip without one.

This file imports no JAX, so it also runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.kernels.flash_decode import (flash_decode, flash_decode_ref,
                                              validity_bias)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


# (B, S, cache lengths, window): one CTA per (row, KV head); batch 1 split
# many ways; a long row with one short valid run (most tiles skipped); a
# window (the heads of rows masked); S one past a tile
DENSE_SHAPES = {
    "ragged": (4, 300, [300, 1, 150, 0], None),
    "batch1_split": (1, 2048, [2048], None),
    "masked_tiles": (1, 8192, [100], None),
    "window": (8, 2048, [2048, 1, 700, 1500, 64, 65, 2000, 0], 256),
    "one_past_a_tile": (2, 65, [1, 65], None),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,dh", [(torch.float32, 64),
                                      (torch.bfloat16, 64),
                                      (torch.bfloat16, 128)])
@pytest.mark.parametrize("shape", sorted(DENSE_SHAPES))
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, dh, shape):
    """f32 inputs: relative max error ≤ 1e-5 on o/l, m and l over the rows
    with a valid position; bf16 inputs: ≤ 1e-3 (both sides accumulate in
    f32 from the same bf16 values).  A fully masked row: m = -1e30 and
    l = S exactly, o = Σ v within the same tolerance."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    B, S, lens, window = DENSE_SHAPES[shape]
    H, Hk = 32, 8
    q = torch.randn(B, H, dh, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(B, S, Hk, dh, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(B, S, Hk, dh, generator=g, device=cuda_device).to(dtype)
    clen = torch.tensor(lens, device=cuda_device)
    bias = validity_bias(B, S, clen, window=window, device=cuda_device)
    before = flash_decode.launches
    got = flash_decode(q, k, v, bias, softcap=50.0)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    want = flash_decode_ref(q, k, v, bias, softcap=50.0)
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    live = clen > 0
    o_g, o_w = got[0] / got[2][..., None], want[0] / want[2][..., None]
    for a, b in ((o_g, o_w), (got[1], want[1]), (got[2], want[2])):
        a, b = a[live], b[live]
        err = ((a - b).abs().max() / b.abs().max()).item()
        assert err <= tol, err
    assert (got[1][~live] == -1e30).all() and (got[2][~live] == S).all()
    if (~live).any():
        assert _rel_err(got[0][~live], want[0][~live]) <= tol


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


# (B, S, P, rank, lengths): the rank's block of an S-position cache split
# P ways sits at global position rank·ceil(S/P): valid positions at that
# offset; a block with none (every length ends before it, as later blocks
# are early in decode); a block of 13 positions (S 50 four ways)
SHARD_CASES = {
    "offset": (4, 48, 2, 1, [30, 48, 25, 40]),
    "empty_block": (4, 48, 2, 1, [24, 10, 1, 5]),
    "ragged_4_ways": (3, 50, 4, 2, [27, 40, 50]),
}


def _shard_inputs(device, dtype, B, Sp, seed, H=32, Hk=8, dh=64):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(B, 1, H, dh, generator=g, device=device).to(dtype),
            torch.randn(B, Sp, Hk, dh, generator=g, device=device).to(dtype),
            torch.randn(B, Sp, Hk, dh, generator=g, device=device).to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_shard_partial_route_matches_plain_version(cuda_device, dtype, case):
    """``dispatch.decode_partials`` with a block's offset launches the
    kernel once, and its partials match the plain version on the same
    inputs: rows with a valid position within 1e-5 (f32) / 1e-3 (bf16)
    relative; rows with none give m = -1e30, l = Sp, o = Σ v."""
    from repro_torch.kernels import dispatch as kdsp
    B, S, P, rank, lens = SHARD_CASES[case]
    Sp = -(-S // P)
    q, k, v = _shard_inputs(cuda_device, dtype, B, Sp, seed=1)
    clen = torch.tensor(lens, device=cuda_device)
    before = flash_decode.launches
    got = kdsp.decode_partials(q, k, v, clen, offset=rank * Sp,
                               logit_softcap=50.0)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    bias = validity_bias(B, Sp, clen, offset=rank * Sp, device=cuda_device)
    want = flash_decode_ref(q[:, 0], k, v, bias, softcap=50.0)
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    live = (bias == 0).any(dim=1)
    assert (case == "empty_block") == (not live.any())
    if live.any():
        o_g, o_w = got[0] / got[2][..., None], want[0] / want[2][..., None]
        for a, b in ((o_g, o_w), (got[1], want[1]), (got[2], want[2])):
            assert _rel_err(a[live], b[live]) <= tol
    if (~live).any():
        assert (got[1][~live] == -1e30).all() and (got[2][~live] == Sp).all()
        assert _rel_err(got[0][~live], want[0][~live]) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merged_shard_partials_match_the_dense_kernel(cuda_device, dtype):
    """Every block's partials through the offset route, merged as the
    ranks merge them (``merge_partials``; the later blocks of the shorter
    rows hold no valid position), against the dense kernel on the whole
    cache: within 1e-5 (f32) / 1e-3 (bf16) relative."""
    from repro_torch.kernels import dispatch as kdsp
    from repro_torch.kernels.flash_decode import merge_partials
    B, S, P = 4, 48, 4
    Sp = S // P
    q, k, v = _shard_inputs(cuda_device, dtype, B, S, seed=2)
    clen = torch.tensor([1, 14, 27, 48], device=cuda_device)
    parts = []
    for r in range(P):
        blk = slice(r * Sp, (r + 1) * Sp)
        parts.append(kdsp.decode_partials(q, k[:, blk].contiguous(),
                                          v[:, blk].contiguous(), clen,
                                          offset=r * Sp))
    got = merge_partials(*(torch.stack(p) for p in zip(*parts)))
    o, m, l = kdsp.decode_partials(q, k, v, clen)       # the whole cache
    want = o / l[..., None]
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) <= (1e-5 if dtype == torch.float32 else 1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_means_kernel_matches_plain_version(cuda_device, dtype):
    """Masked (with an empty segment) and unmasked, at the ViT exchange's
    shape [8, 100, 12·64], L = 20.  f32: relative max error ≤ 1e-5; bf16:
    ≤ 1e-3 (both sum in f32 from the same values).  Counts are exact."""
    from repro_torch.kernels.segment_means import (segment_means,
                                                   segment_means_ref)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(8, 100, 768, generator=g, device=cuda_device).to(dtype)
    mask = torch.rand(8, 100, generator=g, device=cuda_device) > 0.2
    mask[0, :5] = False
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    for m in (mask, None):
        before = segment_means.launches
        got, cnt = segment_means(x, 20, m)
        torch.cuda.synchronize()
        assert segment_means.launches == before + 1
        want, want_cnt = segment_means_ref(x, 20, m)
        assert got.dtype == dtype and _rel_err(got, want) <= tol
        assert torch.equal(cnt, want_cnt)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,dh", [(torch.float32, 64),
                                      (torch.bfloat16, 64),
                                      (torch.bfloat16, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_prism_attention_kernel_matches_plain_version(cuda_device, dtype, dh,
                                                      causal):
    """GQA 8/2 with a key mask, empty segments, softcap and a fully masked
    row (uniform weights, as the plain version gives).  Ragged Nq and Nk.
    The f32 result before the cast to the inputs' type: relative max error
    ≤ 1e-5 for f32 inputs, ≤ 1e-3 for bf16; the bf16 output within one
    bf16 rounding step (2^-7 relative) of the plain version's."""
    from repro_torch.kernels.prism_attention import (build_mean_bias,
                                                     prism_attention,
                                                     prism_attention_ref)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    B, N, H, Hk, P, L = 3, 70, 8, 2, 4, 5

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device).to(dtype)
    q, k, v = randn(B, N, H, dh), randn(B, N, Hk, dh), randn(B, N, Hk, dh)
    km, vm = randn(B, P * L, Hk, dh), randn(B, P * L, Hk, dh)
    mask = torch.rand(B, N, generator=g, device=cuda_device) > 0.3
    mask[2] = False
    counts = torch.randint(0, 4, (B, P, L), generator=g,
                           device=cuda_device).float()
    counts[2] = 0
    bias = build_mean_bias(B, P, L, 1, 14, causal=causal, mean_counts=counts)
    args = (q, k, v, km, vm, bias)
    kw = dict(causal=causal, softcap=30.0, kv_mask=mask)
    before = prism_attention.launches
    got = prism_attention(*args, **kw)
    got32 = prism_attention(*args, **kw, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert prism_attention.launches == before + 2
    want = prism_attention_ref(*args, causal=causal, logit_softcap=30.0,
                               kv_mask=mask)
    want32 = prism_attention_ref(*args, causal=causal, logit_softcap=30.0,
                                 kv_mask=mask, out_dtype=torch.float32)
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    assert _rel_err(got32, want32) <= tol
    assert torch.isfinite(got32).all() and got.dtype == dtype
    step = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert torch.isclose(got.float(), want.float(), rtol=step,
                         atol=1e-6 * want.float().abs().max().item()).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,dh,ps", [(torch.float32, 64, 16),
                                         (torch.bfloat16, 64, 16),
                                         (torch.bfloat16, 128, 8),
                                         (torch.float32, 64, 5)])
@pytest.mark.parametrize("MP", [10, 200])
def test_paged_kernel_matches_plain_version(cuda_device, dtype, dh, ps, MP):
    """The paged flash-decode kernel against its plain version (gather +
    dense math): shuffled pages, row 1 sharing row 0's pages, table entries
    past each row's pages on the trash page, softcap, rows of full length
    and of length 1, and a fully masked row (m = -1e30, l = MP·ps exactly,
    o = Σ v).  MP 200 splits S across CTAs and skips most tiles of the
    short rows.  f32: relative max error ≤ 1e-5; bf16: ≤ 1e-3."""
    from repro_torch.kernels.flash_decode import (flash_decode_paged,
                                                  flash_decode_paged_ref)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    B, H, Hk = 4, 32, 8
    P = B * MP                                   # + the trash page, id P

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device).to(dtype)
    q = randn(B, H, dh)
    k_pool, v_pool = randn(P + 1, ps, Hk, dh), randn(P + 1, ps, Hk, dh)
    clen = torch.tensor([MP * ps, 1, 3 * ps + 2, 0], device=cuda_device)
    table = torch.randperm(P, generator=g, device=cuda_device).reshape(B, MP)
    used = (clen[:, None] + ps - 1) // ps
    table = torch.where(torch.arange(MP, device=cuda_device)[None] < used,
                        table, P)
    table[1, :1] = table[0, :1]
    table = table.to(torch.int32).contiguous()
    bias = validity_bias(B, MP * ps, clen, device=cuda_device)
    before = flash_decode_paged.launches
    got = flash_decode_paged(q, k_pool, v_pool, table, bias, softcap=50.0)
    torch.cuda.synchronize()
    assert flash_decode_paged.launches == before + 1
    want = flash_decode_paged_ref(q, k_pool, v_pool, table, bias,
                                  softcap=50.0)
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    live = clen > 0
    o_g, o_w = got[0] / got[2][..., None], want[0] / want[2][..., None]
    for a, b in ((o_g, o_w), (got[1], want[1]), (got[2], want[2])):
        assert _rel_err(a[live], b[live]) <= tol
    assert (got[1][~live] == -1e30).all()
    assert (got[2][~live] == MP * ps).all()
    assert _rel_err(got[0][~live], want[0][~live]) <= tol


# (dtype, D, masked, element offset of the inputs' base): 16-byte lanes
# with and without a mask, f32, and the scalar path of an odd D and of an
# unaligned base
SEG_KV_CASES = {
    "masked_empty_segment": (torch.bfloat16, 768, True, 0),
    "unmasked": (torch.bfloat16, 768, False, 0),
    "f32": (torch.float32, 768, True, 0),
    "odd_D": (torch.bfloat16, 771, True, 0),
    "unaligned_base": (torch.bfloat16, 768, True, 1),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SEG_KV_CASES))
def test_segment_means_kv_kernel_matches_plain_version(cuda_device, case):
    """K and V at the ViT exchange's shape [8, 100, D], L = 20, in one
    launch, against the plain version applied to each.  f32: relative max
    error ≤ 1e-5; bf16: ≤ 1e-3.  Counts exact."""
    from repro_torch.kernels.segment_means import (segment_means,
                                                   segment_means_kv,
                                                   segment_means_ref)
    dtype, D, masked, off = SEG_KV_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(4)
    B, N, L = 8, 100, 20
    buf = torch.randn(2, B * N * D + off, generator=g,
                      device=cuda_device).to(dtype)
    k, v = (buf[i, off:].view(B, N, D) for i in range(2))
    mask = None
    if masked:
        mask = torch.rand(B, N, generator=g, device=cuda_device) > 0.2
        mask[0, :N // L] = False
    before = segment_means.launches
    means, counts = segment_means_kv(k, v, L, mask)
    torch.cuda.synchronize()
    assert segment_means.launches == before + 1
    assert tuple(means.shape) == (2, B, L, D) and means.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    for i, x in enumerate((k, v)):
        want, want_c = segment_means_ref(x, L, mask)
        assert _rel_err(means[i], want) <= tol
        assert torch.equal(counts, want_c)


def _prism_inputs(device, B, Np, H, Hk, dh, P, L, part, *, causal, masked,
                  seed):
    """q/K/V of one partition, every partition's means as the exchange
    hands them over (a [B, P, L, Hk, dh] view of the gathered
    [P, 2, B, L, Hk, dh] payload) and flat, and the mean bias."""
    from repro_torch.kernels.prism_attention import build_mean_bias
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device).to(
            torch.bfloat16)
    q, k, v = randn(B, Np, H, dh), randn(B, Np, Hk, dh), randn(B, Np, Hk, dh)
    gathered = randn(P, 2, B, L, Hk, dh)
    means = gathered.permute(1, 2, 0, 3, 4, 5)
    flat = [m.reshape(B, P * L, Hk, dh) for m in means]
    mask = counts = None
    if masked:
        mask = torch.rand(B, Np, generator=g, device=device) > 0.1
        mask[:, -3:] = False
        counts = torch.randint(1, Np // L + 1, (B, P, L), generator=g,
                               device=device).float()
        counts[0, -1, -1] = 0
    bias = build_mean_bias(B, P, L, part, Np // L, causal=causal,
                           mean_counts=counts, device=device)
    return (q, k, v, means[0], means[1], bias), flat, mask


def _assert_prism_close(args, flat, *, causal, mask, scale=None,
                        softcap=None):
    """The kernel on ``args`` against the plain version on the flat means:
    the f32 result before the cast within 1e-3 relative max error, the
    bf16 output within one bf16 step (2^-7 relative) per element.  One
    launch per call."""
    from repro_torch.kernels.prism_attention import (prism_attention,
                                                     prism_attention_ref)
    q, k, v, _, _, bias = args
    kw = dict(causal=causal, kv_mask=mask, scale=scale)
    before = prism_attention.launches
    got = prism_attention(*args, softcap=softcap, **kw)
    got32 = prism_attention(*args, softcap=softcap, out_dtype=torch.float32,
                            **kw)
    torch.cuda.synchronize()
    assert prism_attention.launches == before + 2
    plain = (q, k, v, *flat, bias)
    want = prism_attention_ref(*plain, logit_softcap=softcap, **kw)
    want32 = prism_attention_ref(*plain, logit_softcap=softcap,
                                 out_dtype=torch.float32, **kw)
    assert torch.isfinite(got32).all() and _rel_err(got32, want32) <= 1e-3
    assert torch.isclose(got.float(), want.float(), rtol=2.0 ** -7,
                         atol=1e-6 * want.float().abs().max().item()).all()


@pytest.mark.gpu
@pytest.mark.parametrize("part", [0, 1])
def test_prism_attention_reads_the_strided_means(cuda_device, part):
    """The ViT exchange's shape (q/K/V [8, 100, 12, 64], 2 partitions of
    20 means, key mask, an empty segment) with the means as the gather
    leaves them; partition 0 and 1, so the hidden own partition's tiles
    fall first and last."""
    args, flat, mask = _prism_inputs(cuda_device, 8, 100, 12, 12, 64, 2, 20,
                                     part, causal=False, masked=True,
                                     seed=5 + part)
    _assert_prism_close(args, flat, causal=False, mask=mask)


@pytest.mark.gpu
def test_prism_attention_causal_skips_future_tiles(cuda_device):
    """Causal GQA 32/8 over 256 local keys, partition 2 of 4: the CTAs of
    the early queries skip the local tiles wholly in their future, and
    every CTA the own and future partitions' mean tiles."""
    args, flat, mask = _prism_inputs(cuda_device, 2, 256, 32, 8, 64, 4, 16,
                                     2, causal=True, masked=False, seed=7)
    _assert_prism_close(args, flat, causal=True, mask=mask)


@pytest.mark.gpu
def test_prism_attention_without_means(cuda_device):
    """M = 0 (no partition's means, as on one partition): plain causal
    attention over the masked local keys, a fully masked row included, in
    bf16 (tensor cores) and f32 (CUDA cores), against the plain version at
    the tolerances above."""
    from repro_torch.kernels.prism_attention import (prism_attention,
                                                     prism_attention_ref)
    g = torch.Generator(device=cuda_device).manual_seed(8)
    B, N, H, Hk, dh = 2, 70, 8, 2, 64
    mask = torch.rand(B, N, generator=g, device=cuda_device) > 0.3
    mask[1] = False
    bias = torch.zeros(B, 0, device=cuda_device)
    for dtype, tol in ((torch.bfloat16, 1e-3), (torch.float32, 1e-5)):
        def randn(*shape):
            return torch.randn(*shape, generator=g,
                               device=cuda_device).to(dtype)
        q, k, v = randn(B, N, H, dh), randn(B, N, Hk, dh), randn(B, N, Hk, dh)
        none = randn(B, 0, Hk, dh)
        args = (q, k, v, none, none, bias)
        got = prism_attention(*args, causal=True, kv_mask=mask,
                              out_dtype=torch.float32)
        want = prism_attention_ref(*args, causal=True, kv_mask=mask,
                                   out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all() and _rel_err(got, want) <= tol


# (B, S, H, Hk, cache lengths) at dh 128, the heads of the dense archs
# beside llama3.2-1b: qwen1.5-32b's 40/40 (G = 1; B·Hk = 160 CTAs, more
# than the 132 SMs) and internlm2-1.8b's 16/8 (G = 2)
DH128_SHAPES = {
    "g1_two_waves": (4, 48, 40, 40, [48, 48, 48, 48]),
    "g1_ragged": (4, 300, 40, 40, [300, 1, 150, 0]),
    "g1_batch1_split": (1, 2048, 40, 40, [2048]),
    "g2_long": (4, 2048, 16, 8, [2048, 7, 1000, 0]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(DH128_SHAPES))
def test_cuda_kernel_at_dh128_groups_1_and_2(cuda_device, dtype, shape):
    """The tolerances of ``test_cuda_kernel_matches_plain_version``."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    B, S, H, Hk, lens = DH128_SHAPES[shape]
    dh = 128
    q = torch.randn(B, H, dh, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(B, S, Hk, dh, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(B, S, Hk, dh, generator=g, device=cuda_device).to(dtype)
    clen = torch.tensor(lens, device=cuda_device)
    bias = validity_bias(B, S, clen, device=cuda_device)
    got = flash_decode(q, k, v, bias)
    torch.cuda.synchronize()
    want = flash_decode_ref(q, k, v, bias)
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    live = clen > 0
    o_g, o_w = got[0] / got[2][..., None], want[0] / want[2][..., None]
    for a, b in ((o_g, o_w), (got[1], want[1]), (got[2], want[2])):
        assert _rel_err(a[live], b[live]) <= tol
    assert (got[1][~live] == -1e30).all() and (got[2][~live] == S).all()
    if (~live).any():
        assert _rel_err(got[0][~live], want[0][~live]) <= tol


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.gpu
def test_int8_kv_bf16_session_generates_the_cpus_tokens(cuda_device):
    """A small bf16 qwen1.5-32b (its QKV bias, MHA, untied head and int8
    KV cache kept) generates the same greedy tokens on the card, through
    the flash-decode kernel, as on the CPU, through the plain version, from
    the same weights."""
    from repro_torch.api import InferenceSession
    from repro_torch.models import registry
    from repro_torch.configs import get_config
    reduced = dict(n_layers=2, head_dim=128, vocab_size=32)
    cfg = get_config("qwen1.5-32b").reduced(**reduced)
    assert cfg.kv_quant and cfg.dtype == "bfloat16"
    params = registry.init_params(cfg, seed=0, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 7),
                           generator=torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", "cuda"):
        session = InferenceSession.from_config(
            "qwen1.5-32b", reduced=reduced, params=_to(params, dev),
            device=dev)
        before = flash_decode.launches
        out[dev] = session.generate(prompt, 6).cpu()
        launches = flash_decode.launches - before
        assert launches == (5 * cfg.n_layers if dev == "cuda" else 0)
    assert torch.equal(out["cuda"], out["cpu"]), (out["cuda"], out["cpu"])


@pytest.mark.gpu
def test_measured_backend_times_with_cuda_events(cuda_device, monkeypatch):
    """The measured backend on a small session on the card: every entry
    positive, and the times come from CUDA events (two a timed call)."""
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.core.perfmap import PerfKey
    from repro_torch.profiling import H100_SXM, SweepSpec, get_backend
    made = []
    real = torch.cuda.Event

    def counting_event(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]
    monkeypatch.setattr(torch.cuda, "Event", counting_event)
    session = InferenceSession.from_config(
        "llama3.2-1b", reduced={"vocab_size": 64}, device="cuda",
        plans=[ExecutionPlan.local(), ExecutionPlan.prism_sim(L=4, cr=9.9)])
    spec = SweepSpec(batches=(1, 4), crs=(9.9,), bandwidths_mbps=(400.0,))
    pm = session.profile(spec, backend="measured", hardware=H100_SXM,
                         iters=3, warmup=1)
    assert len(made) == 2 * 3 * 2 * 2          # events × iters × plans × B
    assert len(pm) == 4 and pm.hardware == H100_SXM
    assert all(e.total_ms > 0 and e.meta["measured"] for _, e in pm.entries())
    assert get_backend("measured").last_scale > 0
    assert pm.get(PerfKey("local", 4, 0.0, 0.0)).compute_ms > 0


@pytest.mark.gpu
@pytest.mark.parametrize("name,param", [("int8", 0), ("int4", 8),
                                        ("topk", 8)])
def test_codec_payload_on_the_card_is_the_cpus(cuda_device, name, param):
    """The codec exchange encodes on the card: the payload and its
    reconstruction equal the CPU's bit for bit (ties at the k-th magnitude
    included for topk: the stable sort keeps the lower index on both)."""
    from repro_torch.transport import CodecSpec, get_codec
    codec, spec = get_codec(name), CodecSpec(param=param)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 99, 12, 64, generator=g)
    x[..., 32:] = -x[..., :32]           # every magnitude appears twice
    for dtype in (torch.float32, torch.bfloat16):
        xc = x.to(dtype)
        cpu = codec.encode(xc, spec)
        card = codec.encode(xc.to(cuda_device), spec)
        assert cpu.keys() == card.keys()
        for key in cpu:
            assert torch.equal(card[key].cpu(), cpu[key]), (dtype, key)
        want = codec.decode(cpu, spec, shape=xc.shape, dtype=dtype)
        got = codec.decode(card, spec, shape=xc.shape, dtype=dtype)
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_codec_calibration_on_the_card(cuda_device):
    from repro_torch.transport import (calibrate_codec_bws, get_codec,
                                       measure_decode_bw)
    assert measure_decode_bw(get_codec("int8"), iters=3, warmup=1) > 0
    try:
        out = calibrate_codec_bws(force=True, iters=3, warmup=1)
        assert set(out) == {"int8", "int4", "topk"}
        assert all(get_codec(n).decode_bw == bw > 0 for n, bw in out.items())
    finally:
        for n in ("int8", "int4", "topk"):
            get_codec(n).__dict__.pop("decode_bw", None)
            get_codec(n).__dict__.pop("decode_bw_measured", None)


# gemma2-27b's attention: 32/16 heads, dh 128, softcap 50, query scale
# (4608/32)^-0.5 = 1/12 (not dh^-0.5), window 4096 on the local layers
GEMMA = dict(H=32, Hk=16, dh=128, softcap=50.0, scale=(4608 / 32) ** -0.5)
# (B, S, cache lengths, window): the B 4 decode step of a 32-token prompt;
# B 1 at S 4624, where the window masks the first 528 positions
GEMMA_DECODE = {"b4_s48": (4, 48, [48] * 4, None),
                "window": (1, 4624, [4624], 4096)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(GEMMA_DECODE))
def test_flash_decode_at_gemma2_decode_shapes(cuda_device, dtype, shape):
    B, S, lens, window = GEMMA_DECODE[shape]
    H, Hk, dh = GEMMA["H"], GEMMA["Hk"], GEMMA["dh"]
    g = torch.Generator(device=cuda_device).manual_seed(11)
    q = torch.randn(B, H, dh, generator=g, device=cuda_device).to(dtype)
    k, v = (torch.randn(B, S, Hk, dh, generator=g, device=cuda_device)
            .to(dtype) for _ in range(2))
    clen = torch.tensor(lens, device=cuda_device)
    bias = validity_bias(B, S, clen, window=window, device=cuda_device)
    if window is not None:
        assert int((bias < 0).sum()) == S - window
    kw = dict(scale=GEMMA["scale"], softcap=GEMMA["softcap"])
    got = flash_decode(q, k, v, bias, **kw)
    torch.cuda.synchronize()
    want = flash_decode_ref(q, k, v, bias, **kw)
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    o_g, o_w = got[0] / got[2][..., None], want[0] / want[2][..., None]
    for a, b in ((o_g, o_w), (got[1], want[1]), (got[2], want[2])):
        assert _rel_err(a, b) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_shard_partials_merge_to_the_dense_kernel(cuda_device,
                                                           dtype):
    """A windowed layer's sharded decode: each block's partial under the
    window, through the offset route, merged as the ranks merge them,
    against the dense kernel under the same window; a block wholly outside
    the window gives m = -1e30 and l = Sp."""
    from repro_torch.kernels import dispatch as kdsp
    from repro_torch.kernels.flash_decode import merge_partials
    B, S, P, window = 2, 64, 4, 20
    Sp = S // P
    H, Hk, dh = GEMMA["H"], GEMMA["Hk"], GEMMA["dh"]
    q, k, v = _shard_inputs(cuda_device, dtype, B, S, seed=3, H=H, Hk=Hk,
                            dh=dh)
    clen = torch.tensor([64, 40], device=cuda_device)
    kw = dict(window=window, logit_softcap=GEMMA["softcap"],
              scale=GEMMA["scale"])
    parts = []
    for r in range(P):
        blk = slice(r * Sp, (r + 1) * Sp)
        parts.append(kdsp.decode_partials(q, k[:, blk].contiguous(),
                                          v[:, blk].contiguous(), clen,
                                          offset=r * Sp, **kw))
    o0, m0, l0 = parts[0]            # positions 0-15: both rows' windows
    assert (m0 == -1e30).all() and (l0 == Sp).all()    # start at 44 and 20
    got = merge_partials(*(torch.stack(p) for p in zip(*parts)))
    o, m, l = kdsp.decode_partials(q, k, v, clen, **kw)
    assert torch.isfinite(got).all()
    assert _rel_err(got, o / l[..., None]) <= (
        1e-5 if dtype == torch.float32 else 1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("part", [0, 3])
def test_prism_attention_at_the_gemma2_shape(cuda_device, part):
    """A global layer's PRISM attention at gemma2's width across 4 ranks:
    q [1, 2048, 32, 128], 16 KV heads, causal, softcap 50, scale 1/12,
    L 16, means as gathered."""
    args, flat, mask = _prism_inputs(cuda_device, 1, 2048, GEMMA["H"],
                                     GEMMA["Hk"], GEMMA["dh"], 4, 16, part,
                                     causal=True, masked=False, seed=12)
    _assert_prism_close(args, flat, causal=True, mask=mask,
                        scale=GEMMA["scale"], softcap=GEMMA["softcap"])


@pytest.mark.gpu
def test_small_gemma2_generates_the_cpus_tokens(cuda_device):
    """A small f32 gemma2 (one local/global pair, window 16, int8 KV cache,
    dh 64) generates past its window the same greedy tokens on the card,
    through the flash-decode kernel, as on the CPU."""
    from repro_torch.api import InferenceSession
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    reduced = dict(dtype="float32", head_dim=64, n_heads=8, n_kv_heads=4,
                   d_model=256)
    cfg = get_config("gemma2-27b").reduced(**reduced)
    assert cfg.window == 16 and cfg.kv_quant
    params = registry.init_params(cfg, seed=0, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", "cuda"):
        session = InferenceSession.from_config(
            "gemma2-27b", reduced=reduced, params=_to(params, dev),
            device=dev)
        before = flash_decode.launches
        out[dev] = session.generate(prompt, 24).cpu()
        assert flash_decode.launches - before == (
            23 * cfg.n_layers if dev == "cuda" else 0)
    assert torch.equal(out["cuda"], out["cpu"]), (out["cuda"], out["cpu"])


@pytest.mark.gpu
def test_rpc_worker_on_the_card_serves_the_in_process_tokens(cuda_device):
    """A ``repro_torch.rpc.worker`` subprocess on the card (llama3.2-1b at
    full width in f32 from seed 0 — the kernels take head dims 64 and 128,
    the reduced config's is 16 — one slot) behind the router: every
    request served once, with the tokens of an in-process session on the
    card from the same seed; the worker closes at shutdown."""
    import numpy as np
    from repro_torch.fleet import DeviceRegistry, FleetRouter
    from repro_torch.rpc import RpcWorker
    from repro_torch.rpc.worker import build_session
    from repro_torch.serving.queue import Request
    w = None
    try:
        w = RpcWorker("card", seed=0, n_slots=1, chunk=4, max_len=24,
                      device="cuda", full=True, dtype="float32",
                      connect_timeout_s=120.0)
        reg = DeviceRegistry(heartbeat_timeout_s=60.0)
        reg.add(w)
        assert w.codec_bws_measured and w.codec_bws
        router = FleetRouter(reg)
        reqs = [Request(prompt=np.arange(1 + i, 8 + i, dtype=np.int32),
                        n_new=8, seed=i) for i in range(3)]
        for r in reqs:
            router.route(r)
        done = {c.request_id: c for c in router.run()}
        assert sorted(done) == sorted(r.id for r in reqs)
        ref, _, _ = build_session("llama3.2-1b", seed=0, device="cuda",
                                  full=True, dtype="float32")
        for r in reqs:
            want = ref.generate(r.prompt[None], r.n_new,
                                plan=ref.plans[done[r.id].plan_key])
            np.testing.assert_array_equal(np.asarray(done[r.id].tokens),
                                          want.cpu().numpy()[0])
    finally:
        if w is not None:
            w.close()
    assert w.proc.poll() is not None


@pytest.mark.gpu
def test_measured_profile_across_two_ranks_on_the_card(cuda_device):
    """``profile(backend="measured")`` of a small f32 ViT (2 layers, d 256,
    head dim 64, which the kernels take) under local, voltage and prism on
    2 ranks sharing the card, B 1 included: one map on both ranks, its
    partitioned entries charged per rank with the measured staged seconds
    beside the modeled staging, and one decision."""
    import json

    import _torch_ranks
    from repro_torch.core.seq_group import spawn
    small = dict(dtype="float32", n_layers=2, d_model=256, n_heads=4,
                 n_kv_heads=4, head_dim=64, d_ff=512, vocab_size=10)
    job = dict(arch="vit-base-16", reduced=small,
               n_tokens=197, L=20, bw=400.0, batches=(1, 4), iters=3,
               decide=(1, 8), delay=0.0, device="cuda")
    runs = spawn(_torch_ranks.profile_seq, 2, job, timeout=300)
    assert runs[0][0] == runs[1][0]
    assert runs[0][2] == runs[1][2] and runs[0][3] == runs[1][3]
    parts = {k: e for k, e in json.loads(runs[0][0])["entries"].items()
             if not k.startswith("local")}
    assert len(parts) == 4
    for e in parts.values():
        m = e["meta"]
        assert m["per_rank"] and m["seq_group"] == 2
        assert 0 < m["staged_ms_measured"] < m["forward_ms_measured"]
        assert m["staged_calls"] > 0 and e["staging_ms"] > 0
