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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,dh", [(torch.float32, 64),
                                      (torch.bfloat16, 64),
                                      (torch.bfloat16, 128)])
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, dh):
    """f32 inputs: relative max error ≤ 1e-5 on o/l, m and l over the rows
    with a valid position; bf16 inputs: ≤ 1e-3 (both sides accumulate in
    f32 from the same bf16 values).  The fully masked row is exact."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    B, S, H, Hk = 4, 300, 32, 8
    q = torch.randn(B, H, dh, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(B, S, Hk, dh, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(B, S, Hk, dh, generator=g, device=cuda_device).to(dtype)
    clen = torch.tensor([300, 1, 150, 0], device=cuda_device)
    bias = validity_bias(B, S, clen, device=cuda_device)
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


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


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
