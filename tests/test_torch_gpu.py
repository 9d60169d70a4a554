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
