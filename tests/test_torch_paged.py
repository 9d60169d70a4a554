"""The paged slice of the port held against the JAX package on the CPU.

* the paged flash-decode plain version and its op (the CPU route of the
  wrapper) against the JAX package's Pallas paged kernel in interpret mode
  and its gather reference: f32, atol = rtol = 1e-5;
* ``decode_attention_paged`` against the JAX package's dispatch;
* ``decode_step_paged`` logits (≤ 1e-4) and the pool pages it writes
  (≤ 1e-5) against the JAX package's, with the same page table;
* ``decode_step`` with a ``[B]`` ``cache_index`` against the JAX package's
  per-slot step (logits ≤ 1e-4), a write past the end included;
* the int8 / int4 codecs: payloads bit for bit the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdsp
from repro.kernels.flash_decode import paged as jpaged
from repro.kernels.flash_decode.ops import validity_bias as jbias
from repro_torch.kernels import dispatch as tdsp
from repro_torch.kernels.flash_decode import (flash_decode_paged,
                                              flash_decode_paged_op,
                                              flash_decode_paged_ref,
                                              gather_pages, validity_bias)

TOL = dict(atol=1e-5, rtol=1e-5)
CASES = [(2, 9, 16, 4, 4, 2, 16), (3, 13, 8, 3, 6, 3, 32),
         (1, 5, 32, 2, 8, 1, 64)]


def _inputs(seed, B, P, ps, MP, H, Hk, dh, *, trash=False, shared=False,
            masked_row=False):
    """Random q and pools, a random page table (pages repeat), ragged
    lengths; ``trash`` points every entry past a row's pages at the last
    page, ``shared`` gives row 1 row 0's table, ``masked_row`` empties
    row 0."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, dh).astype(np.float32)
    kp = rng.randn(P, ps, Hk, dh).astype(np.float32)
    vp = rng.randn(P, ps, Hk, dh).astype(np.float32)
    pt = rng.randint(0, P, size=(B, MP)).astype(np.int32)
    clen = rng.randint(1, MP * ps + 1, size=B).astype(np.int32)
    if trash:
        used = -(-clen // ps)
        pt = np.where(np.arange(MP)[None] < used[:, None], pt, P - 1)
        pt = pt.astype(np.int32)
    if shared and B > 1:
        pt[1] = pt[0]
    if masked_row:
        clen[0] = 0
    return q, kp, vp, pt, clen


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("B,P,ps,MP,H,Hk,dh", CASES)
@pytest.mark.parametrize("variant", ["plain", "trash", "shared",
                                     "masked_row"])
def test_plain_version_matches_pallas_interpret(B, P, ps, MP, H, Hk, dh,
                                                variant):
    """The port's plain version vs the Pallas paged kernel in interpret
    mode and the JAX gather reference, on the same inputs and bias: o, m
    and l within 1e-5 (a fully masked row: m = -1e30, l = MP·ps on every
    side)."""
    kw = {variant: True} if variant != "plain" else {}
    q, kp, vp, pt, clen = _inputs(B * P, B, P, ps, MP, H, Hk, dh, **kw)
    bias = np.asarray(jbias(B, MP * ps, jnp.asarray(clen)))
    got = flash_decode_paged_ref(*_t(q, kp, vp, pt, bias))
    pallas = jpaged.flash_decode_paged_pallas(*_j(q, kp, vp, pt, bias),
                                              interpret=True)
    ref = jpaged.flash_decode_paged_ref(*_j(q, kp, vp, pt, bias))
    for want in (pallas, ref):
        for g, w in zip(got, want):
            _close(g, w)
    if variant == "masked_row":
        assert got[1][0].eq(-1e30).all() and got[2][0].eq(MP * ps).all()


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_op_cpu_route_matches_jax_op(softcap):
    """``flash_decode_paged_op`` on CPU tensors (the plain route) vs the
    JAX package's op in interpret mode, bias built from ``cache_len`` on
    each side, with trash entries."""
    B, P, ps, MP, H, Hk, dh = 3, 11, 8, 4, 8, 2, 32
    q, kp, vp, pt, clen = _inputs(5, B, P, ps, MP, H, Hk, dh, trash=True)
    before = flash_decode_paged.launches
    got = flash_decode_paged_op(*_t(q[:, None], kp, vp, pt, clen),
                                softcap=softcap)
    assert flash_decode_paged.launches == before      # no kernel on a CPU
    want = jpaged.flash_decode_paged_op(*_j(q[:, None], kp, vp, pt, clen),
                                        softcap=softcap, interpret=True)
    for g, w in zip(got, want):
        _close(g, w)


def test_gather_and_bias_match_jax():
    q, kp, vp, pt, clen = _inputs(6, *CASES[1])
    _close(gather_pages(*_t(kp, pt)), jpaged.gather_pages(*_j(kp, pt)),
           atol=0, rtol=0)
    _close(validity_bias(3, 24, torch.from_numpy(clen)),
           jbias(3, 24, jnp.asarray(clen)), atol=0, rtol=0)


def test_decode_attention_paged_matches_jax_dispatch():
    """The dispatch layer's paged decode attention (normalised, in q's
    dtype) against the JAX package's on the CPU (its reference route)."""
    B, P, ps, MP, H, Hk, dh = 3, 10, 8, 3, 8, 2, 16
    q, kp, vp, pt, clen = _inputs(7, B, P, ps, MP, H, Hk, dh)
    got = tdsp.decode_attention_paged(*_t(q[:, None], kp, vp, pt, clen),
                                      logit_softcap=20.0)
    want = jdsp.decode_attention_paged(*_j(q[:, None], kp, vp, pt, clen),
                                       logit_softcap=20.0)
    assert got.shape == (B, 1, H, dh)
    _close(got, want)
    assert tdsp.backend_info()["decode_attention_paged"] == "reference"


def test_wrapper_has_no_route_but_the_device():
    """A CPU tensor takes the plain version; any other device without a
    kernel raises, it never falls back."""
    q, kp, vp, pt, clen = _t(*_inputs(8, *CASES[0]))
    bias = validity_bias(2, 64, clen)
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_decode_paged(q.to("meta"), kp, vp, pt, bias)


# ---------------------------------------------------------------------------
# the model steps
# ---------------------------------------------------------------------------

ARCH = "llama3.2-1b"


def _models(kv_quant=False):
    """(JAX cfg, JAX params, port cfg, port params), reduced f32 llama."""
    from repro.configs import get_config as jget
    from repro.models import registry as jreg
    from repro_torch.configs import get_config as tget
    from repro_torch.models.bridge import params_from_numpy
    over = dict(dtype="float32", kv_quant=kv_quant)
    jcfg = jget(ARCH).reduced(**over)
    tcfg = tget(ARCH).reduced(**over)
    jparams = jreg.init_params(jcfg, seed=0)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def models():
    return _models()


def _xcfgs(mode):
    from repro.core.exchange import ExchangeConfig as JX
    from repro.core.exchange import ExchangeMode as JM
    from repro_torch.core.exchange import ExchangeConfig as TX
    from repro_torch.core.exchange import ExchangeMode as TM
    if mode == "local":
        return JX(), TX()
    return (JX(JM.PRISM_SIM, seq_shards=2, L=2),
            TX(TM.PRISM_SIM, seq_shards=2, L=2))


@pytest.mark.parametrize("mode", ["local", "prism_sim"])
def test_decode_step_paged_matches_jax(models, mode):
    """One paged step of every row: the same random pool contents, page
    table (shared pages, trash entries) and per-row lengths on both sides;
    logits within 1e-4 and the whole pool, with the pages just written,
    within 1e-5."""
    from repro.models import transformer as jtfm
    from repro_torch.models import transformer as ttfm
    jcfg, jparams, tcfg, tparams = models
    jx, tx = _xcfgs(mode)
    P, ps, MP, S = 12, 8, 3, 4
    rng = np.random.RandomState(11)
    shape = (tcfg.n_layers, P + 1, ps, tcfg.n_kv_heads, tcfg.hd)
    pools = {n: rng.randn(*shape).astype(np.float32) for n in ("k", "v")}
    table = np.array([[3, 7, 12], [3, 5, 12], [0, 1, 2], [12, 12, 12]],
                     np.int32)                     # 12 is the trash page
    lengths = np.array([9, 13, 20, 2], np.int32)
    toks = rng.randint(0, tcfg.vocab_size, (S, 1)).astype(np.int32)
    jpool = {"kv": {n: jnp.asarray(a) for n, a in pools.items()}}
    lj, jpool = jtfm.decode_step_paged(jparams, {"tokens": jnp.asarray(toks)},
                                       jpool, jnp.asarray(table),
                                       jnp.asarray(lengths), jcfg, jx)
    tpool = ttfm.init_page_pool(tcfg, P + 1, ps)
    for n, a in pools.items():
        tpool["kv"][n].copy_(torch.from_numpy(a))
    with torch.inference_mode():
        lt, out = ttfm.decode_step_paged(tparams,
                                         {"tokens": torch.from_numpy(toks)},
                                         tpool, torch.from_numpy(table),
                                         torch.from_numpy(lengths), tcfg, tx)
    assert out is tpool                            # updated in place
    _close(lt, lj, atol=1e-4, rtol=0)
    for n in ("k", "v"):
        _close(tpool["kv"][n], jpool["kv"][n])
        assert not np.array_equal(tpool["kv"][n].numpy(), pools[n])


def test_page_pool_refuses_the_int8_cache():
    from repro_torch.models import transformer as ttfm
    _, _, tcfg, _ = _models(kv_quant=True)
    assert not ttfm.supports_page_pool(tcfg)
    with pytest.raises(ValueError, match="no paged decode path"):
        ttfm.init_page_pool(tcfg, 4, 8)


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("mode", ["local", "prism_sim"])
def test_per_row_decode_step_matches_jax_per_slot(kv_quant, mode):
    """``decode_step`` with a ``[B]`` ``cache_index`` (one batched step,
    each row at its own position) against the JAX package's step run per
    slot, as its slot pool vmaps it: logits within 1e-4, caches within
    1e-5.  Row 2 sits at ``max_len``: its write lands on the last
    position, as JAX's clamped ``dynamic_update_slice`` puts it."""
    from repro.models import transformer as jtfm
    from repro_torch.models import transformer as ttfm
    jcfg, jparams, tcfg, tparams = _models(kv_quant)
    jx, tx = _xcfgs(mode)
    B, S = 3, 12
    rng = np.random.RandomState(12)
    idx = np.array([4, 9, S], np.int32)
    toks = rng.randint(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
    prefix = rng.randint(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    # fill both caches the same way: teacher-forced steps of the prefix
    jcache = jtfm.init_decode_cache(jcfg, B, S)
    tcache = ttfm.init_decode_cache(tcfg, B, S)
    with torch.inference_mode():
        for t in range(S):
            _, jcache = jtfm.decode_step(jparams,
                                         {"tokens": jnp.asarray(
                                             prefix[:, t:t + 1])},
                                         jcache, t, jcfg, jx)
            ttfm.decode_step(tparams,
                             {"tokens": torch.from_numpy(
                                 prefix[:, t:t + 1])},
                             tcache, t, tcfg, tx)
    want_logits, want_cache = [], []
    for b in range(B):
        row = jax.tree.map(lambda a: a[:, b:b + 1], jcache)
        lg, row = jtfm.decode_step(jparams,
                                   {"tokens": jnp.asarray(toks[b:b + 1])},
                                   row, int(idx[b]), jcfg, jx)
        want_logits.append(np.asarray(lg))
        want_cache.append(row)
    with torch.inference_mode():
        got, _ = ttfm.decode_step(tparams, {"tokens": torch.from_numpy(toks)},
                                  tcache, torch.from_numpy(idx), tcfg, tx)
    _close(got, np.concatenate(want_logits), atol=1e-4, rtol=0)
    for name, leaf in tcache["kv"].items():
        want = np.concatenate([np.asarray(c["kv"][name]) for c in want_cache],
                              axis=1)
        _close(leaf.float(), want.astype(np.float32))


# ---------------------------------------------------------------------------
# cold-page codecs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["int8", "int4"])
@pytest.mark.parametrize("param", [0, 16])
def test_quant_codec_payloads_bit_identical_to_jax(name, param):
    """Same f32 input → the same payload bytes (values and scales) and the
    same decoded values; a zero vector and large values included."""
    from repro.transport.codecs import CodecSpec as JS
    from repro.transport.codecs import get_codec as jget
    from repro_torch.transport.codecs import CodecSpec as TS
    from repro_torch.transport.codecs import get_codec as tget
    x = np.random.RandomState(13).randn(2, 3, 4, 64).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 2] *= 1e4
    pj = jget(name).encode(jnp.asarray(x), JS(param=param))
    pt = tget(name).encode(torch.from_numpy(x), TS(param=param))
    assert sorted(pj) == sorted(pt)
    for key in pj:
        a, b = np.asarray(pj[key]), pt[key].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    dj = jget(name).decode(pj, JS(param=param))
    dt = tget(name).decode(pt, TS(param=param))
    assert np.asarray(dj).tobytes() == dt.numpy().tobytes()
    wire = tget(name).wire_bytes(x.shape, np.float32, TS(param=param))
    assert wire == jget(name).wire_bytes(x.shape, jnp.float32,
                                         JS(param=param))
    assert wire == sum(v.numel() * v.element_size() for v in pt.values())
