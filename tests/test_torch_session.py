"""The whole slice on reduced llama3.2-1b: the port's InferenceSession held
against the JAX package's, with the JAX weights carried across by the
params bridge.

* ``forward_lm`` logits under ``local`` and ``prism_sim``: max abs diff
  ≤ 2e-3 (f32, two layers; the logits are O(1));
* greedy ``generate``: token-exact, with and without the int8 KV cache;
* the simulated performance map: equal key for key;
* ``decide`` / ``explain``: same mode, CR and crossovers.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api import ExecutionPlan as JPlan
from repro.api import InferenceSession as JSession
from repro_torch.api import ExecutionPlan as TPlan
from repro_torch.api import InferenceSession as TSession
from repro_torch.models.bridge import params_from_numpy

ARCH = "llama3.2-1b"


def _pair(**over):
    """(JAX session, port session) over the same f32 weights."""
    reduced = {"dtype": "float32", **over}
    js = JSession.from_config(ARCH, plans=[JPlan.local(),
                                           JPlan.prism_sim(L=2, cr=9.9)],
                              reduced=reduced, seed=0)
    np_params = jax.tree.map(np.asarray, js.params)
    tparams = params_from_numpy(np_params, js.cfg, device="cpu")
    ts = TSession.from_config(ARCH, plans=[TPlan.local(),
                                           TPlan.prism_sim(L=2, cr=9.9)],
                              reduced=reduced, params=tparams, device="cpu")
    return js, ts


@pytest.fixture(scope="module")
def sessions():
    return _pair()


def _prompt(seed, B, T, vocab):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, T)
                                               ).astype(np.int32)


def test_bridge_mirrors_the_config(sessions):
    js, ts = sessions
    assert len(ts.params["layers"]) == js.cfg.n_layers
    assert ts.cfg.torch_dtype == torch.float32
    wq = ts.params["layers"][1]["attn"]["wq"]
    np.testing.assert_array_equal(
        wq.numpy(), np.asarray(js.params["layers"]["attn"]["wq"][1]))


@pytest.mark.parametrize("plan_key", ["local", "prism@9.9"])
def test_forward_logits_match(sessions, plan_key):
    js, ts = sessions
    toks = _prompt(1, 2, 16, js.cfg.vocab_size)
    lj = np.asarray(js.run(plan_key, {"tokens": toks}))
    lt = ts.run(plan_key, {"tokens": torch.from_numpy(toks)}).numpy()
    assert lt.shape == lj.shape == (2, 16, js.cfg.vocab_size)
    np.testing.assert_allclose(lt, lj, atol=2e-3, rtol=0)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_greedy_generate_token_exact(kv_quant):
    js, ts = _pair(kv_quant=kv_quant)
    prompt = _prompt(2, 3, 7, js.cfg.vocab_size)
    for key in ("local", "prism@9.9"):
        want = np.asarray(js.generate(prompt, 9, plan=js.plans[key]))
        got = ts.generate(torch.from_numpy(prompt), 9, plan=ts.plans[key])
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_generate_is_deterministic_per_seed(sessions):
    _, ts = sessions
    prompt = torch.from_numpy(_prompt(3, 2, 5, ts.cfg.vocab_size))
    a = ts.generate(prompt, 6, seed=11, temperature=0.8)
    b = ts.generate(prompt, 6, seed=11, temperature=0.8)
    c = ts.generate(prompt, 6, seed=12, temperature=0.8)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_simulated_perfmap_equal_key_for_key(sessions):
    js, ts = sessions
    pj, pt = js.profile(backend="simulated"), ts.profile(backend="simulated")
    ej = {k.encode(): dataclasses.asdict(e) for k, e in pj.entries()}
    et = {k.encode(): dataclasses.asdict(e) for k, e in pt.entries()}
    assert ej == et and len(ej) > 100


@pytest.mark.parametrize("batch,bw", [(1, 400.0), (8, 400.0), (32, 250.0),
                                      (8, 900.0)])
def test_decide_and_explain_agree(sessions, batch, bw):
    js, ts = sessions
    for s in (js, ts):
        if s.perfmap is None:
            s.profile(backend="simulated")
    dj, dt = js.decide(batch, bw), ts.decide(batch, bw)
    assert (dj.mode, dj.cr, dj.codec) == (dt.mode, dt.cr, dt.codec)
    xj, xt = js.explain(batch, bw), ts.explain(batch, bw)
    assert (xj.batch_crossover, xj.bandwidth_crossover, xj.plan_key) == (
        xt.batch_crossover, xt.bandwidth_crossover, xt.plan_key)
    assert xj.summary() == xt.summary()


def test_dispatch_records_and_calibrate(sessions):
    _, ts = sessions
    ts.profile(backend="simulated")
    toks = torch.from_numpy(_prompt(4, 8, 16, ts.cfg.vocab_size))
    out = ts.dispatch({"tokens": toks})
    rec = ts.history[-1]
    assert out.shape == (8, 16, ts.cfg.vocab_size) and rec.batch == 8
    assert rec.exec_key in ts.plans and rec.wall_ms > 0
    rep = ts.calibrate()
    assert rep.records == 1 and rep.updated == 1


def test_card_is_never_replaced_by_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        TSession.from_config(ARCH, device="cuda")


def test_unported_paths_raise_naming_the_roadmap():
    from repro_torch.configs import get_config
    with pytest.raises(KeyError, match="ROADMAP"):
        get_config("gemma2-27b")
    _, ts = _pair()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 5"):
        ts.profile(backend="measured")
    from repro_torch.core.exchange import exchange_attention
    xcfg = TPlan.prism(L=2, cr=4.0).to_exchange_config()
    q = torch.zeros(1, 8, 4, 16)
    kv = torch.zeros(1, 8, 2, 16)
    # a windowed layer's halo exchange is not ported yet
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 7"):
        exchange_attention(q, kv, kv, xcfg, causal=True, window=4)
