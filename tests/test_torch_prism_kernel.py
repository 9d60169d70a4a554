"""PRISM attention in the port against the JAX package, in f32 on the CPU.

The same numpy inputs go through the JAX functions — the Pallas kernel in
interpret mode (``prism_attention_op``, which takes no key mask), its plain
version and the core ``prism_attention`` — and through the port's op,
plain version and dispatch.  Tolerance atol = rtol = 1e-5: both sides
compute the softmax in f32 and differ only in summation order.  The CUDA
kernel itself is held against the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``); its tile size and its
rule for the tiles it need not read are mirrored here and held bit for bit
against the plain softmax.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prism_attention as jpa
from repro.kernels.prism_attention import ops as jops
from repro.kernels.prism_attention import prism_attention_ref as jax_ref
from repro.kernels.prism_attention.kernel import prism_attention_pallas
from repro_torch.kernels import dispatch as tdsp
from repro_torch.core.prism_attention import (NEG_INF, _grouped_scores,
                                              _grouped_values)
from repro_torch.kernels.prism_attention import (build_mean_bias,
                                                 prism_attention,
                                                 prism_attention_op,
                                                 prism_attention_ref)
from repro_torch.kernels.prism_attention import kernel as tkernel

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
    # a meta tensor takes the kernel's shape function (the dry run)
    got = prism_attention(*(t.to("meta") for t in (
        q, kl, vl, km.reshape(1, 4, 2, 8), vm.reshape(1, 4, 2, 8), bias)),
        causal=False)
    assert (got.shape, got.dtype, got.device.type) == \
        (out.shape, out.dtype, "meta")
    assert prism_attention.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        prism_attention(_on_xpu(q), kl, vl, km, vm, bias)


def _on_xpu(t):
    """A stand-in for ``t`` on a device the port has no kernel for (only
    its ``device`` is read before the wrapper refuses it)."""
    import types
    return types.SimpleNamespace(device=torch.device("xpu"), shape=t.shape,
                                 dtype=t.dtype)


# ---------------------------------------------------------------------------
# The bf16 kernel's tiles and the ones it skips, mirrored from the CUDA source
# ---------------------------------------------------------------------------

_SRC = (Path(tkernel.__file__).parent / "csrc" / "prism_attention.cu"
        ).read_text()


def _constant(name: str, namespace: str) -> int:
    body = _SRC.split(f"namespace {namespace} {{", 1)[1]
    return int(re.search(rf"constexpr int {name} = (\d+);", body).group(1))


TK = _constant("TK", "mma_body")            # keys per tile of the bf16 body


def test_tile_constants_match_the_cuda_source():
    """The wrapper's limits are the CUDA source's: at most MAX_WARPS
    consumer warps a CTA and G = H / Hk up to GMAX; the mirror below uses
    the bf16 body's tile size."""
    assert _constant("MAX_WARPS", "mma_body") == tkernel.MAX_WARPS == 8
    assert int(re.search(r"constexpr int GMAX = (\d+);", _SRC).group(1)) \
        == tkernel.ROWS == 32
    assert TK % 16 == 0


@pytest.mark.parametrize("rows", [1, 15, 16, 17, 100, 128, 129, 400, 2048,
                                  12345])
def test_row_plan_holds_the_rows_in_as_few_ctas_as_fit(rows):
    """Consumer warps of 16 rows: the fewest CTAs of at most MAX_WARPS
    warps that hold every row, each CTA as small as that allows; the ViT
    shape (100 rows) is one CTA of 7 warps."""
    warps = tkernel.row_plan(rows)
    ctas = -(-rows // (16 * warps))
    assert 1 <= warps <= tkernel.MAX_WARPS
    assert ctas == -(-rows // (16 * tkernel.MAX_WARPS))
    assert 16 * warps * ctas >= rows > 16 * (warps - 1) * ctas
    if rows == 100:
        assert (warps, ctas) == (7, 1)


def _read_tiles(Nk, P, L, bias_row, mask_row, *, causal, q_offset, qi_min,
                qi_max):
    """(local tiles, mean tiles) one CTA of the bf16 kernel reads for batch
    row b, as its producer warp picks them: the local tiles holding a key
    at or before the CTA's last query (all without causal attention),
    then the mean tiles (TK means of one partition each) holding a bias
    above -1e30; every tile when some row of the CTA would see no key."""
    n_loc, tpp = -(-Nk // TK), -(-L // TK)
    last = q_offset + qi_max
    loc_need = (n_loc if not causal
                else 1 if last < 0 else min(n_loc, last // TK + 1))
    live = sorted({(m // L) * tpp + (m % L) // TK
                   for m in range(P * L) if bias_row[m] > NEG_INF})
    lim = min(Nk, q_offset + qi_min + 1) if causal else Nk
    sees = bool(live) or (lim > 0 if mask_row is None
                          else bool(mask_row[:max(lim, 0)].any()))
    if not sees:
        return list(range(n_loc)), list(range(P * tpp))
    return list(range(loc_need)), live


def _logits(q, k, v, km, vm, bias, *, causal, q_offset, mask):
    """The plain version's logits [B, H, Nq, Nk + M] (``prism_attention_ref``
    up to its softmax)."""
    B, Nq, H, dh = q.shape
    Nk = k.shape[1]
    scale = dh ** -0.5
    l_loc = _grouped_scores(q, k) * scale
    if causal:
        keep = (q_offset + torch.arange(Nq)[:, None]
                >= torch.arange(Nk)[None, :])
        l_loc = torch.where(keep[None, None], l_loc, NEG_INF)
    if mask is not None:
        l_loc = torch.where(mask[:, None, None, :], l_loc, NEG_INF)
    l_mean = _grouped_scores(q, km) * scale + bias[:, None, None, :]
    return torch.cat([l_loc, l_mean], dim=-1)


def _attend(logits, v, vm):
    Nk = v.shape[1]
    p = torch.softmax(logits, dim=-1)
    return _grouped_values(p[..., :Nk], v) + _grouped_values(p[..., Nk:], vm)


@pytest.mark.parametrize("case", ["causal_offset", "own_partition",
                                  "causal_first_partition", "dead_row"])
def test_skipped_tiles_change_nothing(case):
    """Leaving out the tiles the kernel skips — each CTA's, for its own
    rows — gives the plain version's output bit for bit in f32: every
    skipped score is -1e30 for every row of the CTA, and each such row sees
    a key above it, so the skipped exponentials are exactly 0.  A CTA with
    a row that sees nothing reads every tile (uniform weights)."""
    B, H, Hk, dh, P, L = 3, 8, 2, 16, 4, 10
    Nq = Nk = 150 if case == "causal_offset" else 70
    G = H // Hk
    causal = case.startswith("causal")
    part = {"causal_offset": 2, "own_partition": 1,
            "causal_first_partition": 0, "dead_row": 3}[case]
    q_offset = 37 if case == "causal_offset" else 0
    r = np.random.RandomState(len(case))
    f = np.float32
    q, k, v = (torch.from_numpy(r.randn(B, n, h, dh).astype(f))
               for n, h in ((Nq, H), (Nk, Hk), (Nk, Hk)))
    km, vm = (torch.from_numpy(r.randn(B, P, L, Hk, dh).astype(f))
              for _ in range(2))
    mask = torch.from_numpy(r.rand(B, Nk) > 0.2)
    counts = torch.from_numpy(r.randint(0, 3, (B, P, L)).astype(f))
    if case == "dead_row":                # batch row 1 sees no key at all
        mask[1] = False
        counts[1] = 0
    bias = build_mean_bias(B, P, L, part, Nk // L, causal=causal,
                           mean_counts=counts)
    kmf, vmf = km.flatten(1, 2), vm.flatten(1, 2)
    full = _logits(q, k, v, kmf, vmf, bias, causal=causal,
                   q_offset=q_offset, mask=mask)
    want = _attend(full, v, vmf).to(q.dtype)
    assert torch.equal(want, prism_attention_ref(
        q, k, v, kmf, vmf, bias, causal=causal, kv_mask=mask,
        q_offset=q_offset))

    rows = Nq * G
    per = 16 * tkernel.row_plan(rows)
    dropped, kept = 0, full.clone()
    for b in range(B):
        for hk in range(Hk):
            for row0 in range(0, rows, per):
                qi_min, qi_max = row0 // G, (min(rows, row0 + per) - 1) // G
                loc, means = _read_tiles(
                    Nk, P, L, bias[b], mask[b], causal=causal,
                    q_offset=q_offset, qi_min=qi_min, qi_max=qi_max)
                cols = torch.ones(Nk + P * L, dtype=torch.bool)
                for t in loc:
                    cols[t * TK:min((t + 1) * TK, Nk)] = False
                tpp = -(-L // TK)
                for mt in means:
                    p0, l0 = divmod(mt, tpp)
                    lo = Nk + p0 * L + l0 * TK
                    cols[lo:min(lo + TK, Nk + (p0 + 1) * L)] = False
                if b == 1 and case == "dead_row":
                    assert not cols.any()          # reads every tile
                heads = slice(hk * G, (hk + 1) * G)
                qs = slice(qi_min, qi_max + 1)
                blk = kept[b, heads, qs]
                blk[..., cols] = -float("inf")
                kept[b, heads, qs] = blk
                dropped += int(cols.sum())
    assert dropped > 0                             # the rule skips tiles
    got = _attend(kept, v, vmf).to(q.dtype)
    assert torch.equal(got, want)


def test_strided_means_give_the_flat_result():
    """The exchange's means, a [B, P, L, Hk, dh] view strided over B and P
    of the gathered [P, 2, B, L, Hk, dh] payload, give exactly what the
    same means laid out flat as [B, P·L, Hk, dh] give, through the wrapper
    and through the op."""
    B, Np, H, Hk, dh, P, L = 2, 24, 4, 2, 16, 3, 4
    q, kl, vl, km, vm = _t(_inputs(31, B, Np, H, Hk, dh, P, L))
    gathered = torch.stack([km, vm]).permute(2, 0, 1, 3, 4, 5).contiguous()
    means = gathered.permute(1, 2, 0, 3, 4, 5)     # [2, B, P, L, Hk, dh]
    assert not means[0].is_contiguous()
    assert tkernel.mean_layout(means[0]) == (
        P, L, L * Hk * dh, 2 * B * L * Hk * dh)
    assert tkernel.mean_layout(km.flatten(1, 2)) == (1, P * L,
                                                     P * L * Hk * dh, 0)
    bias = build_mean_bias(B, P, L, 1, Np // L, causal=True)
    mask = torch.from_numpy(np.random.RandomState(32).rand(B, Np) > 0.3)
    kw = dict(causal=True, kv_mask=mask, softcap=20.0)
    flat = prism_attention(q, kl, vl, km.flatten(1, 2), vm.flatten(1, 2),
                           bias, **kw)
    assert torch.equal(prism_attention(q, kl, vl, means[0], means[1], bias,
                                       **kw), flat)
    assert torch.equal(prism_attention_op(q, kl, vl, means[0], means[1], 1,
                                          Np // L, causal=True, softcap=20.0,
                                          kv_mask=mask), flat)
