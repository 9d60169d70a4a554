"""gemma2-27b in the port against the JAX package at reduced size in f32
(two layers: one local/global pair, window 16, int8 KV cache, softcaps,
post-norms, ``gelu_tanh``, ``embed_scale``, query scale 1/sqrt(d/H)), the
JAX weights carried across by the params bridge:

* the config: field for field the JAX package's, full and reduced;
* the bridge: ``local_layers`` and ``global_layers`` unstacked bit for bit;
* ``forward_lm`` logits under ``local`` at 40 tokens (the window masks):
  max abs diff ≤ 2e-3, ``last_only`` included;
* ``decode_step`` logits, each step from the JAX cache before it, 26
  steps past the window of 16: ≤ 1e-4, and the position each step writes
  in both halves (codes up to one rounding step, scales within 1e-5);
* greedy ``generate`` through ``InferenceSession``: token-exact, prompt
  and new tokens past the window;
* ``prism_sim`` (and its codec form) on windowed layers raises in both
  packages; ``input_specs``, ``cache_batch_axes`` and the partitioned
  cache layout cover both halves;
* serving: the dense slot pool serves gemma2 token-exact against the JAX
  package's ``ServingRuntime`` (int8 and f32 caches, prompts past the
  window), and the paged pool refuses it in both packages, as the
  reference has no paged decode path for ``local_global``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecutionPlan as JPlan
from repro.api import InferenceSession as JSession
from repro.models import transformer as jtfm
from repro_torch.api import ExecutionPlan as TPlan
from repro_torch.api import InferenceSession as TSession
from repro_torch.models import transformer as ttfm
from repro_torch.models.bridge import params_from_numpy

ARCH = "gemma2-27b"
REDUCED = {"dtype": "float32"}
FWD_TOL, STEP_TOL = 2e-3, 1e-4


def _pair():
    """(JAX session, port session) over the same f32 weights."""
    js = JSession.from_config(ARCH, plans=[JPlan.local()], reduced=REDUCED,
                              seed=0)
    tparams = params_from_numpy(jax.tree.map(np.asarray, js.params), js.cfg,
                                device="cpu")
    ts = TSession.from_config(ARCH, plans=[TPlan.local()], reduced=REDUCED,
                              params=tparams, device="cpu")
    return js, ts


@pytest.fixture(scope="module")
def sessions():
    return _pair()


def _tokens(seed, B, T, vocab):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, T)
                                               ).astype(np.int32)


def _diff(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def test_config_is_the_jax_packages():
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    assert dataclasses.asdict(tget(ARCH)) == dataclasses.asdict(jget(ARCH))
    reduced = tget(ARCH).reduced(**REDUCED)
    assert dataclasses.asdict(reduced) == dataclasses.asdict(
        jget(ARCH).reduced(**REDUCED))
    assert reduced.n_layers == 2 and reduced.window == 16
    assert reduced.local_global and reduced.kv_quant
    assert reduced.n_heads == 2 * reduced.n_kv_heads
    assert reduced.query_scale == (4608 / 32) ** -0.5 != reduced.hd ** -0.5


def test_bridge_unstacks_both_halves(sessions):
    js, ts = sessions
    assert "layers" not in ts.params
    for name in ("local_layers", "global_layers"):
        layers = ts.params[name]
        assert len(layers) == js.cfg.n_layers // 2
        assert set(layers[0]) == set(js.params[name])
        np.testing.assert_array_equal(
            layers[0]["attn"]["wq"].numpy(),
            np.asarray(js.params[name]["attn"]["wq"][0]))
        np.testing.assert_array_equal(
            layers[0]["post_mlp"]["scale"].numpy(),
            np.asarray(js.params[name]["post_mlp"]["scale"][0]))


def test_forward_logits_match(sessions):
    js, ts = sessions
    toks = _tokens(1, 2, 40, js.cfg.vocab_size)
    lj = np.asarray(js.run("local", {"tokens": toks}))
    lt = ts.run("local", {"tokens": torch.from_numpy(toks)}).numpy()
    assert lt.shape == lj.shape == (2, 40, js.cfg.vocab_size)
    assert _diff(lt, lj) <= FWD_TOL
    xj = JPlan.local().to_exchange_config()
    xt = TPlan.local().to_exchange_config()
    last_j = np.asarray(jtfm.forward_lm(js.params,
                                        {"tokens": jnp.asarray(toks)},
                                        js.cfg, xj, last_only=True)[0])
    with torch.inference_mode():
        last_t = ttfm.forward_lm(ts.params, {"tokens": torch.from_numpy(toks)},
                                 ts.cfg, xt, last_only=True)[0].numpy()
    assert last_t.shape == (2, 1, js.cfg.vocab_size)
    assert _diff(last_t, last_j) <= FWD_TOL


def test_decode_step_logits_match(sessions):
    """Each decode step from the JAX package's cache after the steps before
    it, copied into the port's: logits within 1e-4; the position the step
    writes in both halves the same codes up to one rounding step and the
    scales within 1e-5 relative (the int8 cache is why each step starts
    from one cache: ROADMAP, int8 KV rounding)."""
    js, ts = sessions
    B, S = 2, 26
    toks = _tokens(2, B, S, js.cfg.vocab_size)
    xj = JPlan.local().to_exchange_config()
    xt = TPlan.local().to_exchange_config()
    jcache = jtfm.init_decode_cache(js.cfg, B, S)
    assert set(jcache) == {"local", "global"}
    with torch.inference_mode():
        for t in range(S):
            tcache = {half: {n: torch.from_numpy(np.array(a))
                             for n, a in leaves.items()}
                      for half, leaves in jcache.items()}
            lj, jcache = jtfm.decode_step(
                js.params, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jcache,
                t, js.cfg, xj)
            lt, tcache = ttfm.decode_step(
                ts.params, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                tcache, t, ts.cfg, xt)
            assert _diff(lt.numpy(), lj) <= STEP_TOL
            for half, leaves in tcache.items():
                for name, leaf in leaves.items():
                    got = leaf[:, :, t].float().numpy()
                    want = np.asarray(jcache[half][name][:, :, t]
                                      ).astype(np.float32)
                    if "scale" in name:
                        np.testing.assert_allclose(got, want, rtol=1e-5)
                    else:
                        assert np.abs(got - want).max() <= 1


def test_greedy_generate_token_exact(sessions):
    js, ts = sessions
    prompt = _tokens(3, 3, 9, js.cfg.vocab_size)
    want = np.asarray(js.generate(prompt, 20, plan=js.plans["local"]))
    got = ts.generate(torch.from_numpy(prompt), 20, plan=ts.plans["local"])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("codec", ["", "int8"])
def test_prism_sim_raises_on_windowed_layers_in_both_packages(sessions,
                                                              codec):
    js, ts = sessions
    toks = _tokens(5, 1, 16, js.cfg.vocab_size)
    kj = js.add_plan(JPlan("prism_sim", 4.0, 2, "seq", 2, codec=codec))
    kt = ts.add_plan(TPlan("prism_sim", 4.0, 2, "seq", 2, codec=codec))
    assert kj == kt
    with pytest.raises(NotImplementedError, match="sliding window"):
        js.run(kj, {"tokens": toks})
    with pytest.raises(NotImplementedError, match="sliding window"):
        ts.run(kt, {"tokens": torch.from_numpy(toks)})


def test_serving_pools_refuse_local_global(sessions):
    """As in the JAX package, only the paged pool refuses ``local_global``
    (no paged decode path, ``ValueError`` in both packages); the dense
    slot pool takes gemma2, both halves of its cache."""
    js, ts = sessions
    with pytest.raises(ValueError, match="local_global=True"):
        ttfm.init_page_pool(ts.cfg, 8, 4, device="cpu")
    with pytest.raises(ValueError, match="local_global=True"):
        jtfm.init_page_pool(js.cfg, 8, 4)
    assert not ttfm.supports_page_pool(ts.cfg)
    assert not jtfm.supports_page_pool(js.cfg)
    pool = ts.init_slot_pool(2, 16)
    jpool = js.init_slot_pool(2, 16)
    assert set(pool) == set(jpool) == {"local", "global"}
    for half in ("local", "global"):
        assert pool[half]["k"].shape == jpool[half]["k"].shape


def _served_pair(kv_quant):
    """The reduced gemma2 (window 16) served by both packages'
    ``ServingRuntime`` on the dense slot pool: prompts of 5, 20 and 30
    tokens (two past the window) and 24 new tokens each, 2 slots."""
    from repro.serving import ServingRuntime as JRuntime
    from repro_torch.serving import ServingRuntime as TRuntime
    reduced = dict(REDUCED, kv_quant=kv_quant, vocab_size=64)
    js = JSession.from_config(ARCH, plans=[JPlan.local()], reduced=reduced,
                              seed=0)
    ts = TSession.from_config(
        ARCH, plans=[TPlan.local()], reduced=reduced, device="cpu",
        params=params_from_numpy(jax.tree.map(np.asarray, js.params),
                                 js.cfg))
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 64, n) for n in (5, 20, 30)]
    out = []
    for sess, runtime in ((js, JRuntime), (ts, TRuntime)):
        sess.profile(backend="simulated")
        rt = runtime(sess, n_slots=2, chunk=4, max_len=56)
        reqs = [rt.submit(p, 24, seed=i) for i, p in enumerate(prompts)]
        done = {c.request_id: np.asarray(c.tokens) for c in rt.run()}
        out.append([done[r.id] for r in reqs])
    return prompts, js, out


@pytest.mark.parametrize("kv_quant", [True, False])
def test_slot_pool_serves_token_exact_against_the_jax_runtime(kv_quant):
    """Greedy tokens of every request served through the port's dense slot
    pool equal the JAX package's ``ServingRuntime`` on the same weights,
    and its B=1 ``generate`` (window 16 masks both long prompts)."""
    prompts, js, (want, got) = _served_pair(kv_quant)
    for p, w, g in zip(prompts, want, got):
        np.testing.assert_array_equal(g, w)
        ref = np.asarray(js.generate(np.asarray(p, np.int32)[None], 24))[0]
        np.testing.assert_array_equal(g, ref)


def test_paged_runtime_refuses_gemma2_in_both_packages():
    """The paged ``ServingRuntime`` refuses gemma2 when it builds the pool,
    with the same class of error in both packages."""
    from repro.serving import ServingRuntime as JRuntime
    from repro_torch.serving import ServingRuntime as TRuntime
    reduced = dict(REDUCED, vocab_size=64)
    js = JSession.from_config(ARCH, plans=[JPlan.local()], reduced=reduced)
    ts = TSession.from_config(ARCH, plans=[TPlan.local()], reduced=reduced,
                              device="cpu")
    prompt = np.arange(1, 9, dtype=np.int32)
    for sess, runtime in ((js, JRuntime), (ts, TRuntime)):
        sess.profile(backend="simulated")
        rt = runtime(sess, n_slots=2, chunk=4, max_len=32, page_size=8,
                     n_pages=16)
        rt.submit(prompt, 4)
        with pytest.raises(ValueError, match="no paged decode path"):
            rt.run()


def test_cache_layout_covers_both_halves(sessions):
    from repro_torch.api.generation import cache_batch_axes
    from repro_torch.configs import SHAPES_BY_NAME
    from repro_torch.models import registry
    _, ts = sessions
    cfg = ts.cfg
    axes = cache_batch_axes(cfg)
    assert axes == {half: {"k": 1, "v": 1, "k_scale": 1, "v_scale": 1}
                    for half in ("local", "global")}
    xcfg = TPlan.voltage(seq_shards=4).to_exchange_config()
    cache = ttfm.init_decode_cache(cfg, 3, 26, device="cpu", xcfg=xcfg)
    for half in ("local", "global"):
        assert cache[half]["k"].shape == (1, 3, 7, cfg.n_kv_heads, cfg.hd)
        assert cache[half]["k"].dtype == torch.int8
        assert cache[half]["k_scale"].shape == (1, 3, 7, cfg.n_kv_heads)
    specs = registry.input_specs(cfg, SHAPES_BY_NAME["prefill_32k"])
    assert specs["tokens"].shape == (32, 32768)


def test_session_profiles_decides_and_dispatches():
    """The simulated profile, decide and dispatch of the JAX package's
    session, on the port's gemma2 with its ``local`` plan."""
    js, ts = _pair()
    for s in (js, ts):
        s.profile(backend="simulated")
    for B in (1, 8, 32):
        dt, dj = ts.decide(B), js.decide(B)
        assert (dt.mode, dt.cr, dt.codec) == (dj.mode, dj.cr, dj.codec)
        assert dt.expected.total_ms == dj.expected.total_ms
    toks = _tokens(6, 2, 20, js.cfg.vocab_size)
    got = ts.dispatch({"tokens": torch.from_numpy(toks)})
    want = np.asarray(js.run("local", {"tokens": toks}))
    assert _diff(got.numpy(), want) <= FWD_TOL
    js.dispatch({"tokens": toks})
    assert ts.history[-1].exec_key == js.history[-1].exec_key == "local"
