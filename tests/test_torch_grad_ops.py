"""The port's gradients around its kernels, on the CPU.

* ``segment_means_op`` / ``segment_means_kv_op`` (masked and unmasked)
  and ``prism_attention_op`` are ``torch.autograd.Function``s: the forward
  is the kernel's route (here the plain version, run without autograd),
  the backward an explicit formula.  Each is held against autograd of its
  plain version on the same inputs, at ViT-B/16's masked exchange shape
  (per head group: 100 tokens a partition, L 5, padding in the last
  segment) and llama's causal GQA shape (part 1 of 2, L 4, 4 query heads
  a KV head), with ``kv_mask``, ``mean_counts`` (an empty segment
  included), softcap, ``q_offset`` and a fully masked row.  f32: ≤ 1e-5
  of each gradient's largest value (the same f32 math, summed in another
  order); bf16 inputs: one bf16 rounding step at that value (2⁻⁷ of it:
  both sides round the same f32 gradient, whose last bits differ, to
  bf16).
* The counts and the bias take no gradient.
* ``all_reduce``, the one staged collective without a backward, raises
  when an input requires grad, before it touches the process group.
* The recurrent scans give the same bits with and without autograd
  (their preallocated ``out=`` buffers take no gradient, so under
  autograd they stack their steps instead).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.seq_group import SeqGroup
from repro_torch.kernels import dispatch as kdsp
from repro_torch.kernels.prism_attention import (build_mean_bias,
                                                 prism_attention_op,
                                                 prism_attention_ref)
from repro_torch.kernels.segment_means import (segment_means_kv_op,
                                               segment_means_op,
                                               segment_means_ref)

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -7


def _leaf(rng, shape, dtype):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        dtype).requires_grad_()


def _check(got, want, dtype):
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        scale = max(float(b.float().abs().max()), 1e-30)
        assert float((a.float() - b.float()).abs().max()) <= tol * scale


# (B, N, feature, L, masked): ViT's partition of 100 tokens (197 padded to
# 200 over 2 ranks) at its 12 heads of 64 cut to 2 of 16, and llama's part
# of 32 tokens at 2 KV heads of 16
SEG_SHAPES = {"vit": (2, 100, (2, 16), 5, True),
              "llama": (2, 32, (2, 16), 4, False)}


def _seg_mask(B, N, L, masked):
    if not masked:
        return None
    m = torch.ones(B, N, dtype=torch.bool)
    m[:, -3:] = False                     # the ViT padding
    m[1, :N // L] = False                 # an empty segment
    return m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(SEG_SHAPES))
def test_segment_means_gradients_match_the_plain_version(shape, dtype):
    B, N, feat, L, masked = SEG_SHAPES[shape]
    rng = np.random.RandomState(0)
    mask = _seg_mask(B, N, L, masked)
    k, v = (_leaf(rng, (B, N, *feat), dtype) for _ in range(2))
    g = torch.from_numpy(rng.randn(2, B, L, *feat).astype(np.float32)).to(
        dtype)
    means, counts = segment_means_kv_op(k, v, L, mask)
    assert not counts.requires_grad
    got = torch.autograd.grad(means, (k, v), g)
    refs = [segment_means_ref(t.reshape(B, N, -1), L, mask)[0]
            for t in (k, v)]
    ref = torch.stack(refs).reshape(2, B, L, *feat)
    np.testing.assert_array_equal(means.detach().float().numpy(),
                                  ref.detach().float().numpy())
    _check(got, torch.autograd.grad(ref, (k, v), g, retain_graph=True),
           dtype)
    one, _ = segment_means_op(k, L, mask)
    _check(torch.autograd.grad(one, k, g[0]),
           torch.autograd.grad(refs[0], k, g[0].reshape(B, L, -1)), dtype)


def _prism_case(shape, rng, dtype):
    if shape == "vit":      # masked, non-causal, counts, both partitions
        B, Nq, H, Hk, dh, P, L, part = 2, 100, 4, 4, 16, 2, 5, 1
        mask = _seg_mask(B, Nq, L, True)
        counts = torch.full((B, P, L), 20.0)
        counts[:, 1, -1] = 17.0
        counts[1, 0, 0] = 0.0                  # an empty segment
        opts = dict(causal=False, kv_mask=mask, mean_counts=counts)
    elif shape == "llama":  # causal GQA, part 1 of 2
        B, Nq, H, Hk, dh, P, L, part = 2, 32, 8, 2, 16, 2, 4, 1
        opts = dict(causal=True)
    else:                   # softcap, an offset, a fully masked row
        B, Nq, H, Hk, dh, P, L, part = 2, 16, 4, 2, 16, 3, 2, 0
        mask = torch.ones(B, Nq, dtype=torch.bool)
        mask[0] = False
        opts = dict(causal=True, softcap=20.0, q_offset=5, kv_mask=mask)
    q = _leaf(rng, (B, Nq, H, dh), dtype)
    k, v = (_leaf(rng, (B, Nq, Hk, dh), dtype) for _ in range(2))
    km, vm = (_leaf(rng, (B, P, L, Hk, dh), dtype) for _ in range(2))
    return (q, k, v, km, vm), part, Nq // L, opts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ["vit", "llama", "capped"])
def test_prism_attention_gradients_match_the_plain_version(shape, dtype):
    rng = np.random.RandomState(1)
    ins, part, seg, opts = _prism_case(shape, rng, dtype)
    q, k, v, km, vm = ins
    out = prism_attention_op(q, k, v, km, vm, part, seg, **opts)
    g = torch.from_numpy(rng.randn(*out.shape).astype(np.float32)).to(dtype)
    got = torch.autograd.grad(out, ins, g)
    B, P, L = q.shape[0], km.shape[1], km.shape[2]
    bias = build_mean_bias(B, P, L, part, seg, causal=opts["causal"],
                           mean_counts=opts.get("mean_counts"))
    ref = prism_attention_ref(q, k, v, km.flatten(1, 2), vm.flatten(1, 2),
                              bias, causal=opts["causal"],
                              logit_softcap=opts.get("softcap"),
                              kv_mask=opts.get("kv_mask"),
                              q_offset=opts.get("q_offset", 0))
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  ref.detach().float().numpy())
    _check(got, torch.autograd.grad(ref, ins, g), dtype)


def test_dispatch_routes_keep_the_gradient():
    """Through the dispatch layer (the exchange's calls), the gradient of
    the composed PRISM step equals autograd of the plain composition."""
    rng = np.random.RandomState(2)
    ins, part, seg, _ = _prism_case("llama", rng, torch.float32)
    q, k, v, km, vm = ins
    means, _ = kdsp.segment_means_kv(k, v, 4, axis=1)
    kmm = torch.stack([means[0], km[:, 1]], dim=1)
    vmm = torch.stack([means[1], vm[:, 1]], dim=1)
    out = kdsp.prism_attention(q, k, v, kmm, vmm, 1, seg, causal=True)
    got = torch.autograd.grad(out.square().sum(), (q, k, v, km, vm),
                              allow_unused=True)
    ref_means = [segment_means_ref(t.reshape(2, 32, -1), 4)[0].reshape(
        2, 4, 2, 16) for t in (k, v)]
    rk = torch.stack([ref_means[0], km[:, 1]], dim=1).flatten(1, 2)
    rv = torch.stack([ref_means[1], vm[:, 1]], dim=1).flatten(1, 2)
    bias = build_mean_bias(2, 2, 4, 1, seg, causal=True)
    ref = prism_attention_ref(q, k, v, rk, rv, bias, causal=True)
    want = torch.autograd.grad(ref.square().sum(), (q, k, v, km, vm),
                               allow_unused=True)
    for a, b in zip(got, want):
        if b is None:
            assert a is None or float(a.abs().max()) == 0
        else:
            _check([a], [b], torch.float32)


def test_the_bias_and_counts_take_no_gradient():
    rng = np.random.RandomState(3)
    ins, part, seg, opts = _prism_case("vit", rng, torch.float32)
    counts = opts["mean_counts"].requires_grad_()
    out = prism_attention_op(*ins, part, seg, **opts)
    out.sum().backward()
    assert counts.grad is None


def test_collectives_without_a_backward_raise_under_grad():
    """``all_reduce`` (the parameter gradients' sum) alone has no backward:
    it raises before it reaches the process group (none is initialised).
    Every other staged collective trains
    (``tests/test_torch_grad_collectives.py``)."""
    group = SeqGroup("seq", 0, 2)
    t = torch.ones(4, requires_grad=True)
    with pytest.raises(RuntimeError, match="has no backward"):
        group.all_reduce([t])


def test_recurrent_scans_give_the_same_bits_under_autograd():
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.core.exchange import ExchangeConfig
    for arch in ("hymba-1.5b", "xlstm-350m"):
        cfg = get_config(arch).reduced(dtype="float32")
        params = registry.init_params(cfg, seed=0, device="cpu")
        tokens = torch.from_numpy(np.random.RandomState(4).randint(
            0, cfg.vocab_size, (2, 16)).astype(np.int32))
        with torch.no_grad():
            plain, _ = registry.forward_fn(cfg)(params, {"tokens": tokens},
                                                ExchangeConfig())
        live = {k: v for k, v in params.items()}
        live["embed"] = {"table": params["embed"]["table"].clone()
                         .requires_grad_()}
        tracked, _ = registry.forward_fn(cfg)(live, {"tokens": tokens},
                                              ExchangeConfig())
        assert tracked.requires_grad
        np.testing.assert_array_equal(tracked.detach().numpy(),
                                      plain.numpy())
