"""The port's step counter (``repro_torch.launch.hlo_analysis``) against
the JAX package's HLO analyzer (``repro.launch.hlo_analysis``) on the five
known-cost programs of ``tests/test_hlo_analysis.py``, built in both
packages from one numpy seed: the matmul, the 17-layer loop (a Python
loop in the port, a ``lax.scan`` there), the slice-aware bytes, the
nested loop and the elementwise program.  FLOPs within the JAX test's own
tolerances (5 %, 10 %) of the analytic count and of ``analyze_hlo_text``;
the sliced weight charged under half the naive bytes; a chain of matmuls
whose live set is known by hand peaks exactly there.

And the meta route of the four kernels (``repro_torch.kernels.meta``):
each wrapper given meta tensors returns its kernel's output shapes and
dtypes (those of the plain version on the CPU) and books the kernel's own
count, and a traced ``prism`` train step and decode step reach none of the
plain versions.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.hlo_analysis import analyze_hlo_text
from repro_torch.configs import get_config
from repro_torch.core.exchange import ExchangeMode
from repro_torch.kernels import dispatch, meta
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import (CollectiveRecord, HloCost,
                                             StepCounter, analysis_dict)
from repro_torch.launch.mesh import make_auto_mesh

META = torch.device("meta")


def _inputs(*shapes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _jax_cost(fn, arrays):
    args = [jax.ShapeDtypeStruct(a.shape, jnp.float32) for a in arrays]
    return analyze_hlo_text(jax.jit(fn).lower(*args).compile().as_text())


def _port_cost(fn, arrays):
    args = [torch.empty_like(torch.from_numpy(a), device=META)
            for a in arrays]
    with StepCounter() as c:
        fn(*args)
    return c


def test_matmul_flops():
    arrays = _inputs((128, 256), (256, 512))
    expect = 2 * 128 * 256 * 512
    want = _jax_cost(lambda x, y: x @ y, arrays)
    got = _port_cost(lambda x, y: x @ y, arrays)
    assert got.flops == pytest.approx(expect, rel=0.05)
    assert got.flops == pytest.approx(want.flops, rel=0.05)


def test_layer_loop_counts_every_layer():
    """The JAX analyzer multiplies a scan's body by its trip count; the
    port's loop is a Python loop, each layer counted as it runs."""
    n_layers = 17
    arrays = _inputs((64, 128), (n_layers, 128, 128))

    def jf(x, ws):
        def body(h, w):
            return jnp.tanh(h @ w), None
        return jax.lax.scan(body, x, ws)[0]

    def tf(x, ws):
        for i in range(n_layers):
            x = torch.tanh(x @ ws[i])
        return x

    expect = n_layers * 2 * 64 * 128 * 128
    want, got = _jax_cost(jf, arrays), _port_cost(tf, arrays)
    assert got.flops == pytest.approx(expect, rel=0.10)
    assert got.flops == pytest.approx(want.flops, rel=0.10)


def test_bytes_slice_aware():
    """A loop that reads one element of a [128, 128] slice of a stacked
    weight per step is charged the slice it reads, not the whole stack."""
    n = 16
    arrays = _inputs((8, 8), (n, 128, 128))

    def tf(x, ws):
        for i in range(n):
            x = x * 1.0 + ws[i][0, 0]
        return x

    got = _port_cost(tf, arrays)
    full_per_iter = n * (n * 128 * 128 * 4)      # what naive counting gives
    assert got.bytes < full_per_iter / 2


def test_nested_loop():
    arrays = _inputs((32, 64), (5, 64, 64))

    def jf(x, ws):
        def outer(h, w):
            def inner(g, _):
                return g @ w, None
            return jax.lax.scan(inner, h, None, length=3)[0], None
        return jax.lax.scan(outer, x, ws)[0]

    def tf(x, ws):
        for i in range(5):
            for _ in range(3):
                x = x @ ws[i]
        return x

    expect = 5 * 3 * 2 * 32 * 64 * 64
    want, got = _jax_cost(jf, arrays), _port_cost(tf, arrays)
    assert got.flops == pytest.approx(expect, rel=0.10)
    assert got.flops == pytest.approx(want.flops, rel=0.10)


def test_elementwise_counted_linear():
    arrays = _inputs((1024, 1024))
    got = _port_cost(lambda x: torch.tanh(x) + x * 2.0, arrays)
    want = _jax_cost(lambda x: jnp.tanh(x) + x * 2.0, arrays)
    for c in (got, want):
        assert 1024 * 1024 <= c.flops <= 6 * 1024 * 1024


def test_known_peak_of_a_matmul_chain():
    """h ← h @ w_i over 4 weights: the step allocates each product and
    frees the one before it once the next exists, so at most two [64,
    256] f32 products (2 × 64 KiB) are alive; the arguments are counted
    apart."""
    arrays = _inputs((64, 256), *[(256, 256)] * 4)

    def chain(h, *ws):
        for w in ws:
            h = h @ w
        return h

    args = [torch.empty_like(torch.from_numpy(a), device=META)
            for a in arrays]
    with StepCounter() as c:
        out = chain(*args)
        assert c.output_bytes(out) == 64 * 256 * 4
    assert c.peak == 2 * 64 * 256 * 4
    assert c.flops == 4 * 2 * 64 * 256 * 256


def test_collective_records_and_roofline_terms():
    from repro_torch.profiling.hardware import (H100_GLOO_STAGED,
                                                H100_HBM_BW, H100_PEAK_FLOPS)
    from repro_torch.launch.hlo_analysis import collective
    rec = collective("all-gather", 1000, 4, booked="payload",
                     received_bytes=3000, calls=1)
    assert rec.wire_bytes == 3000
    assert collective("all-reduce", 1000, 4, booked="grad",
                      received_bytes=3000, calls=1).wire_bytes == 1500
    assert collective("reduce-scatter", 1000, 4, booked="grad",
                      received_bytes=750, calls=1).wire_bytes == 750
    cost = HloCost(2e12, 3e9, [rec])
    twice = cost.scaled(2.0)
    assert twice.collective_calls == 2 and twice.flops == 4e12
    roof = analysis_dict(cost, 256)
    assert roof["compute_s"] == 2e12 / H100_PEAK_FLOPS
    assert roof["memory_s"] == 3e9 / H100_HBM_BW
    link = H100_GLOO_STAGED
    assert roof["collective_s"] == pytest.approx(
        link.staging_fixed_ms / 1e3 + 2 * 3000 / link.staging_bw_base)
    assert roof["collectives"]["all-gather"]["received_bytes"] == 3000
    assert isinstance(cost.collectives[0], CollectiveRecord)


# --- the kernels' meta route ------------------------------------------------

def _cpu_and_meta(fn, *tensors):
    """``fn`` on CPU tensors (the plain versions) and on meta copies under
    a counter → (CPU outputs, meta outputs, the counter)."""
    out_cpu = fn(*tensors)
    metas = [t.to(META) if isinstance(t, torch.Tensor) else t
             for t in tensors]
    with StepCounter() as c:
        out_meta = fn(*metas)
    return out_cpu, out_meta, c


def _same_shapes(a, b):
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    assert [(t.shape, t.dtype) for t in a] == [(t.shape, t.dtype) for t in b]
    assert all(t.device == META for t in b)


def test_meta_route_flash_decode():
    B, S, H, Hk, dh = 2, 48, 8, 2, 64
    q, k, v = (torch.randn(B, 1, H, dh), torch.randn(B, S, Hk, dh),
               torch.randn(B, S, Hk, dh))
    for offset, clen, window, valid in ((0, 40, None, 40), (24, 30, None, 6),
                                        (24, 10, None, S), (0, 40, 8, 8)):
        cpu, got, c = _cpu_and_meta(
            lambda q, k, v: dispatch.decode_partials(
                q, k, v, clen, offset=offset, window=window), q, k, v)
        _same_shapes(cpu, got)
        flops, moved = c.by_op["flash_decode"][1:]
        assert flops == 4 * H * dh * B * valid
        assert moved == (B * H * dh * 4 + B * S * 4 + 2 * B * valid * Hk
                         * dh * 4 + (B * H * dh + 2 * B * H) * 4)


def test_meta_route_segment_means_and_prism_attention():
    B, N, Hk, dh, L = 2, 16, 2, 16, 4
    k, v = torch.randn(B, N, Hk, dh), torch.randn(B, N, Hk, dh)
    mask = torch.ones(B, N, dtype=torch.bool)
    cpu, got, c = _cpu_and_meta(
        lambda k, v, m: dispatch.segment_means_kv(k, v, L, m), k, v, mask)
    _same_shapes(cpu, got)
    assert c.by_op["segment_means"][1] == 2 * 2 * B * N * Hk * dh
    H, P, part = 4, 3, 2
    q = torch.randn(B, N, H, dh)
    km, vm = torch.randn(B, P, L, Hk, dh), torch.randn(B, P, L, Hk, dh)
    for causal, seen in ((True, part * L), (False, (P - 1) * L)):
        cpu, got, c = _cpu_and_meta(
            lambda q, k, v, km, vm: dispatch.prism_attention(
                q, k, v, km, vm, part, N // L, causal=causal),
            q, k, v, km, vm)
        _same_shapes(cpu, got)
        local = N * (N + 1) // 2 if causal else N * N
        assert c.by_op["prism_attention"][1] == \
            2 * H * 2 * dh * B * (local + N * seen)
    assert meta.causal_pairs(4, 10, 3) == 4 + 5 + 6 + 7


def test_meta_route_paged():
    B, H, Hk, dh, P, ps, MP = 2, 4, 2, 16, 6, 8, 3
    q = torch.randn(B, 1, H, dh)
    kp, vp = torch.randn(P, ps, Hk, dh), torch.randn(P, ps, Hk, dh)
    table = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    lens = torch.tensor([20, 9], dtype=torch.int32)
    cpu, got, c = _cpu_and_meta(
        lambda q, kp, vp, t, n: dispatch.decode_attention_paged(
            q, kp, vp, t, n), q, kp, vp, table, lens)
    _same_shapes(cpu, got)
    assert c.by_op["flash_decode_paged"][1] == 4 * H * dh * B * MP * ps


def _refusing(name):
    def refuse(*a, **k):
        raise AssertionError(f"a meta tensor reached {name}")
    return refuse


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_traced_step_reaches_no_plain_version(kind):
    """A ``prism`` step traced on a (2, 2) mesh: the kernels' shape
    functions run and book, and no plain version sees a meta tensor."""
    from repro_torch.kernels.flash_decode import kernel as fk
    from repro_torch.kernels.flash_decode import paged as fp
    from repro_torch.kernels.prism_attention import kernel as pk
    from repro_torch.kernels.segment_means import kernel as sk
    cfg = get_config("llama3.2-1b").reduced(dtype="float32")
    with mock.patch.object(fk, "flash_decode_ref", _refusing("fd")), \
            mock.patch.object(fp, "flash_decode_paged_ref",
                              _refusing("fdp")), \
            mock.patch.object(pk, "prism_attention_ref", _refusing("pa")), \
            mock.patch.object(sk, "segment_means_ref", _refusing("sm")):
        got = dryrun.trace_step(cfg, kind, make_auto_mesh((2, 2),
                                                          ("data", "model")),
                                mode=ExchangeMode.PRISM, B=4, N=16, L=4)
    ops = got["counter"].by_op
    if kind == "train":          # forward, recompute: 2 a layer
        assert ops["prism_attention"][0] == 2 * cfg.n_layers
        assert ops["segment_means"][0] == 2 * cfg.n_layers
    else:
        assert ops["flash_decode"][0] == cfg.n_layers
