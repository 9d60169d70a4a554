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
                                      (torch.bfloat16, 128),
                                      (torch.float32, 16),
                                      (torch.bfloat16, 16)])
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
                                      (torch.bfloat16, 128),
                                      (torch.float32, 16),
                                      (torch.bfloat16, 16)])
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
                                         (torch.float32, 64, 5),
                                         (torch.float32, 16, 8),
                                         (torch.bfloat16, 16, 5)])
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
                  seed, dv=None, dtype=torch.bfloat16):
    """q/K/V of one partition, every partition's means as the exchange
    hands them over (a [B, P, L, Hk, dh] view of the gathered
    [P, 2, B, L, Hk, dh] payload; with a value width ``dv`` apart, the
    MLA exchange's contiguous [B, P, L, Hk, ·] K and V means) and flat,
    and the mean bias."""
    from repro_torch.kernels.prism_attention import build_mean_bias
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device).to(dtype)
    q, k = randn(B, Np, H, dh), randn(B, Np, Hk, dh)
    if dv is None:
        v = randn(B, Np, Hk, dh)
        gathered = randn(P, 2, B, L, Hk, dh)
        means = gathered.permute(1, 2, 0, 3, 4, 5)
    else:
        v = randn(B, Np, Hk, dv)
        means = (randn(B, P, L, Hk, dh), randn(B, P, L, Hk, dv))
    flat = [m.reshape(B, P * L, Hk, m.shape[-1]) for m in means]
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
                        softcap=None, atol=1e-6):
    """The kernel on ``args`` against the plain version on the flat means:
    the f32 result before the cast within 1e-3 relative max error, the
    bf16 output within one bf16 step (2^-7 relative) per element, plus
    ``atol`` times the largest output.  One launch per call."""
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
                         atol=atol * want.float().abs().max().item()).all()


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
    return None if tree is None else tree.to(device)


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


MLA = dict(H=128, dqk=192, dv=128)     # deepseek-v2's PRISM attention


@pytest.mark.gpu
@pytest.mark.parametrize("part", [0, 1])
def test_prism_attention_at_the_mla_shape(cuda_device, part):
    """deepseek-v2's latent exchange on 2 ranks: q [4, 256, 128, 192],
    128 KV heads (G 1), V 128 wide, causal, L 16, the means expanded
    from the gathered latent; partitions 0 and 1.  The f32 results agree
    to about 2e-6 of the largest output, as at the other widths; over 16.8
    M outputs a near-zero one can then round to either side of a bf16
    step, so the per-element check allows 1e-5 of the largest output."""
    args, flat, mask = _prism_inputs(cuda_device, 4, 256, MLA["H"],
                                     MLA["H"], MLA["dqk"], 2, 16, part,
                                     causal=True, masked=False, seed=20,
                                     dv=MLA["dv"])
    _assert_prism_close(args, flat, causal=True, mask=mask, atol=1e-5)


@pytest.mark.gpu
def test_prism_attention_at_the_mla_shape_in_f32_and_masked(cuda_device):
    """The (192, 128) instantiation's CUDA-core body in f32 (≤ 1e-5) and
    its tensor-core body with a key mask that hides every local key of a
    batch row whose means are hidden too (part 0, causal: the uniform
    row), against the plain version; output V-wide."""
    from repro_torch.kernels.prism_attention import (prism_attention,
                                                     prism_attention_ref)
    args, flat, _ = _prism_inputs(cuda_device, 2, 64, 8, 8, MLA["dqk"], 2,
                                  16, 1, causal=True, masked=False, seed=21,
                                  dv=MLA["dv"], dtype=torch.float32)
    got = prism_attention(*args, causal=True)
    want = prism_attention_ref(*args[:3], *flat, args[5], causal=True)
    assert got.shape == (2, 64, 8, MLA["dv"])
    assert _rel_err(got, want) <= 1e-5
    args, flat, _ = _prism_inputs(cuda_device, 2, 64, 8, 8, MLA["dqk"], 2,
                                  16, 0, causal=True, masked=False, seed=22,
                                  dv=MLA["dv"])
    mask = torch.ones(2, 64, dtype=torch.bool, device=cuda_device)
    mask[1] = False
    _assert_prism_close(args, flat, causal=True, mask=mask)


@pytest.mark.gpu
def test_prism_attention_refuses_widths_it_has_no_body_for(cuda_device):
    """A CUDA tensor at widths no instantiation takes raises; it is never
    sent to the plain version."""
    from repro_torch.kernels.prism_attention import prism_attention
    args, _, _ = _prism_inputs(cuda_device, 1, 32, 4, 4, 128, 2, 4, 1,
                               causal=True, masked=False, seed=23, dv=64)
    with pytest.raises(ValueError, match="widths"):
        prism_attention(*args, causal=True)


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


# the cross-attention memories: (heads, KV heads, dh, real length M0, the
# memory padded for P 2 and L 16), whisper-large-v3's encoder frames and
# llama-3.2-vision-11b's image tokens
MEMORY = {"whisper": (20, 20, 64, 1500, 1504),
          "vision": (32, 8, 128, 1601, 1632)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("memory", sorted(MEMORY))
def test_flash_decode_over_the_cross_attention_memories(cuda_device, dtype,
                                                        memory):
    """A decode step's cross-attention on one card: B 4 over the whole
    memory (S 1500 at 20/20 heads dh 64, S 1601 at 32/8 dh 128, every
    position valid) through ``dispatch.decode_attention`` and
    ``dispatch.decode_partials``, one launch each, against the plain
    version: the f32 partials (o·l / l, m, l) within 1e-5 / 1e-3
    relative, and the output in the inputs' dtype (f32: within 1e-5
    relative; bf16: every element within one bf16 rounding step, 2^-7
    relative, of the plain version's rounded output, plus 1e-6 of the
    largest)."""
    from repro_torch.kernels import dispatch as kdsp
    H, Hk, dh, M0, _ = MEMORY[memory]
    q, k, v = _shard_inputs(cuda_device, dtype, 4, M0, seed=30, H=H, Hk=Hk,
                            dh=dh)
    valid = torch.full((4,), M0, device=cuda_device)
    before = flash_decode.launches
    out = kdsp.decode_attention(q, k, v, valid)
    got = kdsp.decode_partials(q, k, v, valid)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 2
    assert out.shape == (4, 1, H, dh) and out.dtype == dtype
    want = flash_decode_ref(q[:, 0], k, v, torch.zeros(4, M0,
                                                       device=cuda_device))
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    for a, b in ((got[0] / got[2][..., None], want[0] / want[2][..., None]),
                 (got[1], want[1]), (got[2], want[2])):
        assert _rel_err(a, b) <= tol
    want_out = (want[0] / want[2][..., None]).to(dtype).float()
    if dtype == torch.float32:
        assert _rel_err(out[:, 0], want_out) <= tol
    else:
        assert torch.isclose(out[:, 0].float(), want_out, rtol=2.0 ** -7,
                             atol=1e-6 * want_out.abs().max().item()).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("memory", sorted(MEMORY))
def test_shard_partial_over_a_memory_block(cuda_device, dtype, memory):
    """Rank 1 of 2's block of the padded memory (Mp 752 with 748 real
    frames, Mp 816 with 785 real image tokens) at offset Mp under the
    global valid length, and both blocks merged against the dense kernel
    over the unpadded memory."""
    from repro_torch.kernels import dispatch as kdsp
    from repro_torch.kernels.flash_decode import merge_partials
    H, Hk, dh, M0, M = MEMORY[memory]
    Mp = M // 2
    q, k, v = _shard_inputs(cuda_device, dtype, 4, M, seed=31, H=H, Hk=Hk,
                            dh=dh)
    valid = torch.full((4,), M0, device=cuda_device)
    parts = [kdsp.decode_partials(q, k[:, r * Mp:(r + 1) * Mp].contiguous(),
                                  v[:, r * Mp:(r + 1) * Mp].contiguous(),
                                  valid, offset=r * Mp) for r in (0, 1)]
    bias = validity_bias(4, Mp, valid, offset=Mp, device=cuda_device)
    assert int((bias == 0).sum(dim=1)[0]) == M0 - Mp
    want = flash_decode_ref(q[:, 0], k[:, Mp:].contiguous(),
                            v[:, Mp:].contiguous(), bias)
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    got = parts[1]
    assert _rel_err(got[0] / got[2][..., None], want[0] / want[2][..., None]
                    ) <= tol
    merged = merge_partials(*(torch.stack(p) for p in zip(*parts)))
    o, _, l = kdsp.decode_partials(q, k[:, :M0].contiguous(),
                                   v[:, :M0].contiguous(), valid)
    assert _rel_err(merged, o / l[..., None]) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("memory", sorted(MEMORY))
def test_masked_segment_means_over_a_memory_block(cuda_device, memory):
    """K and V of the last block of the padded memory in one launch, L 16
    (segments of 47 or 51 tokens): [4, 752, 20·64] with its last 4 frames
    padding, [4, 816, 8·128] with its last 31 image tokens, against the
    plain version: the bf16 means each within one bf16 rounding step (a
    mean on a rounding boundary may take either neighbour: the kernel
    multiplies by 1 / count where the plain version divides, and sums in
    another order), the same values in f32 within 1e-5 relative, counts
    exact."""
    from repro_torch.kernels.segment_means import (segment_means,
                                                   segment_means_kv,
                                                   segment_means_ref)
    H, Hk, dh, M0, M = MEMORY[memory]
    Mp, L = M // 2, 16
    g = torch.Generator(device=cuda_device).manual_seed(32)
    k, v = (torch.randn(4, Mp, Hk * dh, generator=g, device=cuda_device)
            .to(torch.bfloat16) for _ in range(2))
    mask = (torch.arange(Mp, device=cuda_device) < M0 - Mp)[None].repeat(
        4, 1)
    before = segment_means.launches
    means, counts = segment_means_kv(k, v, L, mask)
    means32, counts32 = segment_means_kv(k.float(), v.float(), L, mask)
    torch.cuda.synchronize()
    assert segment_means.launches == before + 2
    assert means.dtype == torch.bfloat16 and means32.dtype == torch.float32
    for i, x in enumerate((k, v)):
        want, want_c = segment_means_ref(x, L, mask)
        assert torch.isclose(means[i].float(), want.float(), rtol=2.0 ** -7,
                             atol=0.0).all()
        want32, _ = segment_means_ref(x.float(), L, mask)
        assert _rel_err(means32[i], want32) <= 1e-5
        assert torch.equal(counts, want_c) and torch.equal(counts32, want_c)
    assert counts[0, -1] == Mp // L - (M - M0)


@pytest.mark.gpu
@pytest.mark.parametrize("part", [0, 1])
@pytest.mark.parametrize("memory", sorted(MEMORY))
def test_masked_cross_prism_attention_over_a_memory_block(cuda_device, memory,
                                                          part):
    """The PRISM cross-attention of a text partition q [4, 256, H, dh]
    over its memory block of 752 or 816 keys under the block's mask
    (non-causal, Nq ≠ Nk) and the means of both blocks as gathered
    ([4, 2, 16, Hk, dh] views), their counts from the masks: partitions
    0 and 1 against the plain version."""
    from repro_torch.kernels.prism_attention import build_mean_bias
    H, Hk, dh, M0, M = MEMORY[memory]
    Mp, L = M // 2, 16
    g = torch.Generator(device=cuda_device).manual_seed(33 + part)

    def randn(*shape):
        return torch.randn(*shape, generator=g,
                           device=cuda_device).to(torch.bfloat16)
    q, k, v = randn(4, 256, H, dh), randn(4, Mp, Hk, dh), randn(4, Mp, Hk, dh)
    means = randn(2, 2, 4, L, Hk, dh).permute(1, 2, 0, 3, 4, 5)
    flat = [m.reshape(4, 2 * L, Hk, dh) for m in means]
    real = (torch.arange(M, device=cuda_device) < M0).reshape(2, L, -1)
    counts = real.sum(dim=-1).float()[None].repeat(4, 1, 1)    # [B, P, L]
    mask = (torch.arange(Mp, device=cuda_device) + part * Mp < M0)[None]
    mask = mask.repeat(4, 1)
    bias = build_mean_bias(4, 2, L, part, Mp // L, causal=False,
                           mean_counts=counts)
    _assert_prism_close((q, k, v, means[0], means[1], bias), flat,
                        causal=False, mask=mask)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["whisper-large-v3", "llama-3.2-vision-11b"])
def test_small_memory_models_generate_the_cpus_tokens(cuda_device, arch):
    """A small f32 whisper and vision model (dh 64, a memory that pads
    under ``prism_sim``, the vlm gates at 0.5) generate with
    ``batch_extras`` the same greedy tokens on the card, self- and
    cross-attention decode through the flash-decode kernel, as on the
    CPU, under ``local`` and ``prism_sim``."""
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    reduced = dict(dtype="float32", head_dim=64, n_heads=4, d_model=256,
                   n_kv_heads=4 if arch == "whisper-large-v3" else 2)
    cfg = get_config(arch).reduced(**reduced)
    params = registry.init_params(cfg, seed=0, device="cpu")
    for cp in params.get("cross_layers", []):
        cp["gate"].fill_(0.5)
    g = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (2, 8), generator=g)
    name = "frames" if cfg.family == "audio" else "image_embeds"
    extras = {name: torch.randn(2, 13, cfg.d_model, generator=g)}
    plans = [ExecutionPlan.local(), ExecutionPlan.prism_sim(L=2, cr=1.0)]
    n_mem = cfg.n_layers if cfg.family == "audio" else \
        cfg.n_layers // cfg.cross_attn_every
    n_self = cfg.n_layers if cfg.family == "audio" else cfg.n_layers - n_mem
    out = {}
    for dev in ("cpu", "cuda"):
        session = InferenceSession(cfg, _to(params, dev), device=dev,
                                   plans=plans)
        for plan in plans:
            before = flash_decode.launches
            out[dev, plan.mode] = session.generate(
                prompt, 6, plan=plan, batch_extras=extras).cpu()
            steps = 5 + (8 if plan.mode == "prism_sim" else 0)
            assert flash_decode.launches - before == (
                steps * (n_self + n_mem) if dev == "cuda" else 0)
    for plan in plans:
        assert torch.equal(out["cuda", plan.mode], out["cpu", plan.mode])


# hymba-1.5b's attention: 25 query heads over 5 KV heads of 64, a group of
# G = 5, the first neither a power of two nor a divisor of a warp (the
# kernels' row tiles run part full)
HYMBA_HEADS = (25, 5, 64)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_at_a_group_of_five(cuda_device, dtype):
    """B 4, S 48 at 25/5 heads: every head of every row (random lengths,
    row 0 fully masked) against the plain version, as the dense case."""
    H, Hk, dh = HYMBA_HEADS
    g = torch.Generator(device=cuda_device).manual_seed(40)
    q = torch.randn(4, H, dh, generator=g, device=cuda_device).to(dtype)
    k, v = (torch.randn(4, 48, Hk, dh, generator=g, device=cuda_device)
            .to(dtype) for _ in range(2))
    clen = torch.tensor([0, 48, 17, 5], device=cuda_device)
    bias = validity_bias(4, 48, clen, device=cuda_device)
    got = flash_decode(q, k, v, bias)
    want = flash_decode_ref(q, k, v, bias)
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    live = clen > 0
    o_g, o_w = got[0] / got[2][..., None], want[0] / want[2][..., None]
    for a, b in ((o_g, o_w), (got[1], want[1]), (got[2], want[2])):
        assert _rel_err(a[live], b[live]) <= tol
    assert (got[1][0] == -1e30).all() and (got[2][0] == 48).all()
    # each query head of a group reads its own row of q: no head repeats
    # another's output
    assert not torch.equal(o_g[1, 0], o_g[1, 4])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shard_partials_merge_at_a_group_of_five(cuda_device, dtype):
    """Both blocks of S 48 over 2 ranks at 25/5 heads (one row with no
    valid position in block 1) through ``dispatch.decode_partials``,
    merged against the dense kernel on the whole cache."""
    from repro_torch.kernels import dispatch as kdsp
    from repro_torch.kernels.flash_decode import merge_partials
    H, Hk, dh = HYMBA_HEADS
    q, k, v = _shard_inputs(cuda_device, dtype, 4, 48, seed=41, H=H, Hk=Hk,
                            dh=dh)
    valid = torch.tensor([40, 17, 24, 48], device=cuda_device)
    parts = [kdsp.decode_partials(q, k[:, r * 24:(r + 1) * 24].contiguous(),
                                  v[:, r * 24:(r + 1) * 24].contiguous(),
                                  valid, offset=r * 24) for r in (0, 1)]
    merged = merge_partials(*(torch.stack(p) for p in zip(*parts)))
    o, _, l = kdsp.decode_partials(q, k, v, valid)
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    assert _rel_err(merged, o / l[..., None]) <= tol
    assert (parts[1][1][1] == -1e30).all()


@pytest.mark.gpu
def test_segment_means_at_hymba_width(cuda_device):
    """K and V [4, 256, 5·64] in one launch at L 16, the width the hymba
    ``prism`` exchange gives: bf16 means within one rounding step, f32
    within 1e-5."""
    from repro_torch.kernels.segment_means import (segment_means_kv,
                                                   segment_means_ref)
    g = torch.Generator(device=cuda_device).manual_seed(42)
    k, v = (torch.randn(4, 256, 5 * 64, generator=g, device=cuda_device)
            .to(torch.bfloat16) for _ in range(2))
    means, _ = segment_means_kv(k, v, 16, None)
    means32, _ = segment_means_kv(k.float(), v.float(), 16, None)
    for i, x in enumerate((k, v)):
        want, _ = segment_means_ref(x, 16, None)
        assert torch.isclose(means[i].float(), want.float(), rtol=2.0 ** -7,
                             atol=0.0).all()
        assert _rel_err(means32[i], segment_means_ref(x.float(), 16,
                                                      None)[0]) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("part", [0, 1])
def test_causal_prism_attention_at_a_group_of_five(cuda_device, part):
    """q [4, 256, 25, 64] over 5 KV heads, causal, both partitions' means
    as gathered (L 16): partitions 0 and 1 against the plain version."""
    from repro_torch.kernels.prism_attention import build_mean_bias
    H, Hk, dh = HYMBA_HEADS
    g = torch.Generator(device=cuda_device).manual_seed(43 + part)

    def randn(*shape):
        return torch.randn(*shape, generator=g,
                           device=cuda_device).to(torch.bfloat16)
    q, k, v = randn(4, 256, H, dh), randn(4, 256, Hk, dh), randn(4, 256, Hk,
                                                                dh)
    means = randn(2, 2, 4, 16, Hk, dh).permute(1, 2, 0, 3, 4, 5)
    flat = [m.reshape(4, 32, Hk, dh) for m in means]
    bias = build_mean_bias(4, 2, 16, part, 16, causal=True,
                           device=cuda_device)
    _assert_prism_close((q, k, v, means[0], means[1], bias), flat,
                        causal=True, mask=None)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-350m"])
def test_small_recurrent_models_generate_the_cpus_tokens(cuda_device, arch):
    """A small f32 hymba at G 5 (10/2 heads of 64) and a small xLSTM
    generate the same greedy tokens on the card as on the CPU; hymba's
    decode runs every attention layer through the flash-decode kernel,
    xLSTM launches none."""
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    reduced = (dict(dtype="float32", head_dim=64, n_heads=10, n_kv_heads=2,
                    d_model=640) if arch == "hymba-1.5b"
               else dict(dtype="float32", d_model=256, n_layers=4))
    cfg = get_config(arch).reduced(**reduced)
    params = registry.init_params(cfg, seed=0, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(0))
    plan = ExecutionPlan.local()
    out = {}
    for dev in ("cpu", "cuda"):
        session = InferenceSession(cfg, _to(params, dev), device=dev,
                                   plans=[plan])
        before = flash_decode.launches
        out[dev] = session.generate(prompt, 6, plan=plan).cpu()
        attn = cfg.n_layers if cfg.family == "hybrid" else 0
        assert flash_decode.launches - before == (
            13 * attn if dev == "cuda" else 0)
    assert torch.equal(out["cuda"], out["cpu"])


# --- training: the autograd functions and the gradient across 2 ranks -----

def _train_leaf(g, shape, dtype):
    return torch.randn(*shape, generator=g, device="cuda").to(
        dtype).requires_grad_()


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp(min=1e-30)).item()


# (B, Np, H, Hk, dh, P, L, part, causal, masked): llama3.2-1b's prism train
# shape (rank 1 of 2 at N 512) and ViT-B/16's (rank 1's 100 tokens, 3 pads)
TRAIN_SHAPES = {"llama": (4, 256, 32, 8, 64, 2, 16, 1, True, False),
                "vit": (8, 100, 12, 12, 64, 2, 20, 1, False, True)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(TRAIN_SHAPES))
def test_prism_autograd_functions_on_the_card(cuda_device, shape, dtype):
    """The kernel route (CUDA forward, explicit backward) of
    ``prism_attention_op`` and ``segment_means_kv_op`` against autograd of
    the plain versions on the same inputs: the gradients of q, K, V and
    the gathered means within 1e-5 (f32) or one bf16 rounding step at the
    largest value (2^-7 of it), relative max error; the kernels launched."""
    from repro_torch.kernels.prism_attention import (build_mean_bias,
                                                     prism_attention,
                                                     prism_attention_op,
                                                     prism_attention_ref)
    from repro_torch.kernels.segment_means import (segment_means,
                                                   segment_means_kv_op,
                                                   segment_means_ref)
    torch.backends.cuda.matmul.allow_tf32 = False
    B, Np, H, Hk, dh, P, L, part, causal, masked = TRAIN_SHAPES[shape]
    g = torch.Generator(device="cuda").manual_seed(3)
    q = _train_leaf(g, (B, Np, H, dh), dtype)
    k, v = (_train_leaf(g, (B, Np, Hk, dh), dtype) for _ in range(2))
    gathered = _train_leaf(g, (P, 2, B, L, Hk, dh), dtype)
    km, vm = gathered.permute(1, 2, 0, 3, 4, 5)
    seg = Np // L
    mask = counts = None
    if masked:
        mask = torch.ones(B, Np, dtype=torch.bool, device="cuda")
        mask[:, -3:] = False
        counts = torch.full((B, P, L), float(seg), device="cuda")
        counts[:, part, -1] = seg - 3
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    before = (prism_attention.launches, segment_means.launches)
    out = prism_attention_op(q, k, v, km, vm, part, seg, causal=causal,
                             kv_mask=mask, mean_counts=counts)
    means, _ = segment_means_kv_op(k, v, L, mask)
    assert (prism_attention.launches, segment_means.launches) == (
        before[0] + 1, before[1] + 1)
    go = torch.randn(out.shape, generator=g, device="cuda").to(dtype)
    gm = torch.randn(means.shape, generator=g, device="cuda").to(dtype)
    leaves = (q, k, v, gathered)
    got = torch.autograd.grad((out, means), leaves, (go, gm))
    bias = build_mean_bias(B, P, L, part, seg, causal=causal,
                           mean_counts=counts, device="cuda")
    ref = prism_attention_ref(q, k, v, km.flatten(1, 2), vm.flatten(1, 2),
                              bias, causal=causal, kv_mask=mask)
    ref_means = torch.stack([segment_means_ref(t.reshape(B, Np, -1), L,
                                               mask)[0]
                             for t in (k, v)]).reshape(means.shape)
    want = torch.autograd.grad((ref, ref_means), leaves, (go, gm),
                               allow_unused=True)
    assert _rel(out, ref) <= tol and _rel(means, ref_means) <= tol
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and _rel(a, b) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["voltage", "prism"])
def test_two_rank_gradient_sum_on_the_card_matches_the_cpu(cuda_device,
                                                           mode):
    """A small f32 llama's gradient summed over 2 ranks on the card (the
    kernels' forward, the explicit backward, the gather's reduce-scattered
    cotangent) against the same 2 ranks on the CPU: the loss shares' sum
    ≤ 1e-5 relative, every leaf ≤ 1e-4 of its largest value; the two
    ranks' sums bit-identical; under ``prism`` both kernels launched."""
    import numpy as np

    import _torch_ranks
    from repro_torch.configs import get_config
    from repro_torch.core.seq_group import spawn
    from repro_torch.models import registry
    reduced = dict(dtype="float32", head_dim=64, n_heads=8, n_kv_heads=2,
                   d_model=256)
    cfg = get_config("llama3.2-1b").reduced(**reduced)
    params = registry.init_params(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(1)

    def batch():
        return {k: rng.randint(0, cfg.vocab_size, (2, 32)).astype(np.int32)
                for k in ("tokens", "labels")}
    job = dict(arch="llama3.2-1b", reduced=reduced, tparams=params, L=4,
               modes=(mode,), batch=batch(), steps=[])
    runs = {dev: spawn(_torch_ranks.train_seq, 2, dict(job, device=dev),
                       timeout=300) for dev in ("cuda", "cpu")}
    card, cpu = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(sum(r[mode]["loss"] for r in card),
                               sum(r[mode]["loss"] for r in cpu), rtol=1e-5)
    for a, b in zip(card[0][mode]["grads"], cpu[0][mode]["grads"]):
        assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), 1e-30)
    for a, b in zip(card[1][mode]["grads"], card[0][mode]["grads"]):
        np.testing.assert_array_equal(a, b)
    if mode == "prism":
        assert all(min(r[mode]["booked"]["launches"]) > 0 for r in card)


@pytest.mark.gpu
@pytest.mark.parametrize("P", [2, 4])
def test_collective_backwards_are_transposes_on_the_card(cuda_device, P):
    """The staged collectives' backwards with CUDA tensors (staged through
    pinned host memory), on P ranks sharing the card: Σ ⟨op(x), y⟩ =
    Σ ⟨x, opᵀ(y)⟩ bit for bit (dyadic inputs: every sum exact), and each
    backward's ``grad`` bytes what the CPU ranks book
    (``tests/test_torch_grad_collectives.py``)."""
    import _torch_ranks
    from repro_torch.core.seq_group import spawn
    runs = {dev: spawn(_torch_ranks.grad_collectives, P,
                       dict(seed=3, device=dev), timeout=300)
            for dev in ("cuda", "cpu")}
    card, cpu = runs["cuda"], runs["cpu"]
    assert card[0].keys() == cpu[0].keys()
    for name in card[0]:
        dot = sum(r[name]["dot"] for r in card)
        assert dot == sum(r[name]["back"] for r in card), name
        assert dot == sum(r[name]["dot"] for r in cpu), name
        assert [r[name]["grad"] for r in card] == [r[name]["grad"]
                                                   for r in cpu], name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduced_llama_generates_on_the_kernels_at_head_width_16(
        cuda_device, dtype):
    """The reduced llama (4/2 heads of 16, every example's width) greedy-
    decodes on the card through the flash-decode kernel, never its plain
    version: f32 tokens equal the CPU's; bf16 runs and launches."""
    from repro_torch.api import InferenceSession
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    reduced = {"vocab_size": 128, "dtype": str(dtype).split(".")[1]}
    cfg = get_config("llama3.2-1b").reduced(**reduced)
    assert cfg.hd == 16
    params = registry.init_params(cfg, seed=0, device="cpu")
    prompt = torch.randint(0, 128, (2, 8),
                           generator=torch.Generator().manual_seed(0))
    tokens = {}
    for dev in ("cuda", "cpu"):
        session = InferenceSession.from_config(
            "llama3.2-1b", reduced=reduced, device=dev,
            params=_to(params, dev))
        before = flash_decode.launches
        tokens[dev] = session.generate(prompt.to(dev), 8).cpu()
        if dev == "cuda":
            assert flash_decode.launches > before
    if dtype == torch.float32:
        assert torch.equal(tokens["cuda"], tokens["cpu"])


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree if tree is None else tree.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["voltage", "prism"])
def test_mesh_gradient_and_step_on_the_card_match_the_cpu(cuda_device,
                                                           mode):
    """A small f32 llama on a (2, 2) mesh of ranks sharing the card (each
    row a seq group, the batch over ``data``, ZeRO shards) against the same
    mesh on the CPU: the loss ≤ 1e-5 relative, the gradient summed over
    the mesh and gathered whole ≤ 1e-4 of each leaf's largest value, the
    params after one AdamW step within 1e-6 where the gradient's sign is
    sure (AdamW's first step moves a param by about lr · sign(g):
    ``tests/_train_oracle.py:check_step``'s line) and 2 · lr elsewhere; on
    the card the ranks of a row hold bit-identical shards and every rank
    gathers the same whole params; under ``prism`` both kernels
    launched."""
    import numpy as np

    import _torch_ranks
    from repro_torch.configs import get_config
    from repro_torch.core.seq_group import spawn_mesh
    from repro_torch.models import registry
    reduced = dict(dtype="float32", head_dim=64, n_heads=8, n_kv_heads=2,
                   d_model=256)
    cfg = get_config("llama3.2-1b").reduced(**reduced)
    params = registry.init_params(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(1)
    batch = {k: rng.randint(0, cfg.vocab_size, (4, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    job = dict(arch="llama3.2-1b", reduced=reduced, tparams=params, L=4,
               modes=(mode,), batch=batch)
    runs = {dev: spawn_mesh(_torch_ranks.mesh_train, (2, 2),
                            ("data", "model"), dict(job, device=dev),
                            timeout=300) for dev in ("cuda", "cpu")}
    card, cpu = runs["cuda"][0][mode], runs["cpu"][0][mode]
    np.testing.assert_allclose(card["loss"], cpu["loss"], rtol=1e-5)
    for k, b in cpu["grads"].items():
        a = card["grads"][k]
        assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), 1e-30), k
        sure = np.abs(b) > 100 * max(float(np.abs(a - b).max()), 1e-12)
        d = np.abs(card["params"][k] - cpu["params"][k])
        assert (d[sure] <= 1e-6).all() and (d <= 2e-3 + 1e-6).all(), k
    rows = {}
    for r in runs["cuda"]:
        rows.setdefault(r["coords"]["data"], set()).add(r[mode]["shard_digest"])
        assert r[mode]["param_digest"] == card["param_digest"]
        if mode == "prism":
            assert min(r[mode]["launches"]) > 0
    assert all(len(d) == 1 for d in rows.values())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["local", "prism"])
def test_tp_decode_step_on_the_card_matches_the_cpu(cuda_device, mode):
    """The serving step builders on a (2, 2) mesh of ranks sharing the
    card, a small f32 llama (8/2 heads of 64): under ``local`` each rank
    its 4/1 heads (G 4), its MLP columns and vocabulary rows, its rows of
    the batch; under ``prism`` the cache sequence-sharded with the MLP
    split over the row.  Against the same mesh on the CPU: every decode
    step's logits ≤ 1e-4 of their largest, the prefill's ≤ 1e-4, greedy
    tokens exact, and flash-decode launched on the card."""
    import numpy as np

    import _torch_ranks
    from repro_torch.configs import get_config
    from repro_torch.core.seq_group import spawn_mesh
    from repro_torch.models import registry
    reduced = dict(dtype="float32", head_dim=64, n_heads=8, n_kv_heads=2,
                   d_model=256)
    cfg = get_config("llama3.2-1b").reduced(**reduced)
    params = registry.init_params(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(2)
    prompt = rng.randint(0, cfg.vocab_size, (4, 8)).astype(np.int32)
    case = dict(arch="llama3.2-1b", reduced=reduced, tparams=params,
                mode=mode, L=2, steps=6, prompt=prompt)
    runs = {dev: spawn_mesh(_torch_ranks.tp_mesh, (2, 2), ("data", "model"),
                            dict(serve={"s": dict(case, device=dev)}),
                            timeout=300) for dev in ("cuda", "cpu")}
    for card, cpu in zip(runs["cuda"], runs["cpu"]):
        a, b = card["serve"]["s"], cpu["serve"]["s"]
        for key in ("prefill", "logits"):
            assert np.abs(a[key] - b[key]).max() <= \
                1e-4 * np.abs(b[key]).max(), key
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert a["launches"] > 0 and b["launches"] == 0
        assert a["tp_keys"]


@pytest.mark.gpu
def test_uneven_tp_decode_step_on_the_card_matches_the_cpu(cuda_device):
    """``build_decode_step`` under ``local`` on a (1, 2) mesh of ranks
    sharing the card, a small f32 hymba of 5/5 heads of 64: its heads
    split 3/2 by whole KV groups (each rank its cache's KV heads), its
    MLP and vocabulary split, its Mamba by inner channel.  Against the
    same mesh on the CPU: every step's logits ≤ 1e-4 of their largest,
    the prefill's ≤ 1e-4, greedy tokens exact, flash-decode launched on
    the card at each rank's head count."""
    import numpy as np

    import _torch_ranks
    from repro_torch.configs import get_config
    from repro_torch.core.seq_group import spawn_mesh
    from repro_torch.models import registry
    reduced = dict(dtype="float32", head_dim=64, n_heads=5, n_kv_heads=5,
                   d_model=320)
    cfg = get_config("hymba-1.5b").reduced(**reduced)
    params = registry.init_params(cfg, seed=0, device="cpu")
    prompt = np.random.RandomState(3).randint(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    case = dict(arch="hymba-1.5b", reduced=reduced, tparams=params,
                mode="local", steps=5, prompt=prompt)
    runs = {dev: spawn_mesh(_torch_ranks.tp_mesh, (1, 2), ("data", "model"),
                            dict(serve={"s": dict(case, device=dev)}),
                            timeout=300) for dev in ("cuda", "cpu")}
    for card, cpu in zip(runs["cuda"], runs["cpu"]):
        a, b = card["serve"]["s"], cpu["serve"]["s"]
        for key in ("prefill", "logits"):
            assert np.abs(a[key] - b[key]).max() <= \
                1e-4 * np.abs(b[key]).max(), key
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert a["launches"] > 0 and b["launches"] == 0
        assert a["kv_heads"] == (3, 2)[card["coords"]["model"]]


@pytest.mark.gpu
def test_dry_run_bytes_match_the_card_ranks(cuda_device):
    """The dry run's abstract collectives against ranks on the card: a
    small f32 llama on a (2, 2) mesh of ranks sharing the card, a
    ``prism`` and a ``local`` TP train step (the kernels launched under
    ``prism``) and a ``prism`` decode step; on every rank the dry run at
    its coordinates (``launch.dryrun.trace_step`` on the meta device)
    books the same ``GatherStats`` as the rank (bytes by kind, calls,
    halo and state calls), call for call."""
    import _torch_ranks
    from repro_torch.core.exchange import ExchangeMode
    from repro_torch.core.seq_group import spawn_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_auto_mesh
    names = ("data", "model")
    cases = {label: dict(arch="llama3.2-1b", kind=kind, mode=mode, B=4,
                         N=32, L=4)
             for label, kind, mode in (("prism", "train", "prism"),
                                       ("local", "train", "local"),
                                       ("decode", "decode", "prism"))}
    ranks = spawn_mesh(_torch_ranks.dryrun_mesh, (2, 2), names,
                       {"cases": cases, "device": "cuda"}, timeout=300)
    mesh = make_auto_mesh((2, 2), names)
    for r in ranks:
        for label, c in cases.items():
            with _torch_ranks.logged_calls() as log:
                got = dryrun.trace_step(_torch_ranks.dry_cfg(c), c["kind"],
                                        mesh, mode=ExchangeMode(c["mode"]),
                                        B=c["B"], N=c["N"], L=c["L"],
                                        coords=r["coords"])
            assert got["gather"]["by_axis"] == r[label]["stats"], label
            assert log == r[label]["log"], label
