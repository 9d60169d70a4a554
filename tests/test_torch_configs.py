"""The port's dense configs internlm2-1.8b (GQA 2:1, untied head) and
qwen1.5-32b (MHA, QKV bias, untied head, int8 KV cache) held against the
JAX package at reduced size in f32, weights carried across by the params
bridge:

* the configs: field for field the JAX package's;
* ``forward_lm`` logits under ``local`` and ``prism_sim``: max abs diff
  ≤ 2e-3 (f32, three layers; the logits are O(1));
* ``decode_step`` logits from the same cache: ≤ 1e-4 (qwen through its
  int8 cache on both sides), and the position each step writes;
* greedy ``generate``: token-exact against ``session.generate``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecutionPlan as JPlan
from repro.api import InferenceSession as JSession
from repro_torch.api import ExecutionPlan as TPlan
from repro_torch.api import InferenceSession as TSession
from repro_torch.models.bridge import params_from_numpy

ARCHS = ("internlm2-1.8b", "qwen1.5-32b")
REDUCED = {"dtype": "float32", "n_layers": 3}


def _pair(arch):
    """(JAX session, port session) over the same f32 weights."""
    js = JSession.from_config(arch, plans=[JPlan.local(),
                                           JPlan.prism_sim(L=2, cr=9.9)],
                              reduced=REDUCED, seed=0)
    tparams = params_from_numpy(jax.tree.map(np.asarray, js.params), js.cfg,
                                device="cpu")
    ts = TSession.from_config(arch, plans=[TPlan.local(),
                                           TPlan.prism_sim(L=2, cr=9.9)],
                              reduced=REDUCED, params=tparams, device="cpu")
    return js, ts


@pytest.fixture(scope="module", params=ARCHS)
def sessions(request):
    return _pair(request.param)


def _tokens(seed, B, T, vocab):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, T)
                                               ).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_jax_packages(arch):
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    assert dataclasses.asdict(tget(arch)) == dataclasses.asdict(jget(arch))
    reduced = tget(arch).reduced(**REDUCED)
    assert not reduced.tie_embeddings
    if arch == "qwen1.5-32b":       # the reduced model keeps what it forces
        assert reduced.kv_quant and reduced.qkv_bias
        assert reduced.n_heads == reduced.n_kv_heads
    else:
        assert reduced.n_heads == 2 * reduced.n_kv_heads


def test_bridge_carries_the_untied_head_and_biases(sessions):
    js, ts = sessions
    np.testing.assert_array_equal(ts.params["lm_head"]["table"].numpy(),
                                  np.asarray(js.params["lm_head"]["table"]))
    attn = ts.params["layers"][2]["attn"]
    assert ("bq" in attn) == js.cfg.qkv_bias
    if js.cfg.qkv_bias:
        np.testing.assert_array_equal(
            attn["bk"].numpy(),
            np.asarray(js.params["layers"]["attn"]["bk"][2]))


@pytest.mark.parametrize("plan_key", ["local", "prism@9.9"])
def test_forward_logits_match(sessions, plan_key):
    js, ts = sessions
    toks = _tokens(1, 2, 16, js.cfg.vocab_size)
    lj = np.asarray(js.run(plan_key, {"tokens": toks}))
    lt = ts.run(plan_key, {"tokens": torch.from_numpy(toks)}).numpy()
    assert lt.shape == lj.shape == (2, 16, js.cfg.vocab_size)
    np.testing.assert_allclose(lt, lj, atol=2e-3, rtol=0)


@pytest.mark.parametrize("mode", ["local", "prism_sim"])
def test_decode_step_logits_match(sessions, mode):
    """Each decode step from the same cache: the JAX package's cache after
    the steps before it, copied into the port's.  Logits within 1e-4; the
    position the step writes within 1e-5, or for qwen's int8 cache the
    same codes up to one rounding step and the scales within 1e-5
    relative.  (The int8 cache is why each step starts from one cache: a
    code that sits on a rounding boundary can round either way under f32
    noise, and a flipped code moves the next steps' logits by about 1e-4.)
    """
    from repro.models import transformer as jtfm
    from repro_torch.models import transformer as ttfm
    js, ts = sessions
    plan = "local" if mode == "local" else "prism@9.9"
    jx = js.plans[plan].to_exchange_config()
    tx = ts.plans[plan].to_exchange_config()
    B, S = 2, 10
    toks = _tokens(2, B, S, js.cfg.vocab_size)
    jcache = jtfm.init_decode_cache(js.cfg, B, S)
    assert ("k_scale" in jcache["kv"]) == js.cfg.kv_quant
    with torch.inference_mode():
        for t in range(S):
            tcache = {"kv": {n: torch.from_numpy(np.array(a))
                             for n, a in jcache["kv"].items()}}
            lj, jcache = jtfm.decode_step(js.params,
                                          {"tokens": jnp.asarray(
                                              toks[:, t:t + 1])},
                                          jcache, t, js.cfg, jx)
            lt, tcache = ttfm.decode_step(ts.params,
                                          {"tokens": torch.from_numpy(
                                              toks[:, t:t + 1])},
                                          tcache, t, ts.cfg, tx)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                       atol=1e-4, rtol=0)
            for name, leaf in tcache["kv"].items():
                got = leaf[:, :, t].float().numpy()
                want = np.asarray(jcache["kv"][name][:, :, t]
                                  ).astype(np.float32)
                if name in ("k", "v") and js.cfg.kv_quant:
                    assert np.abs(got - want).max() <= 1
                elif "scale" in name:
                    np.testing.assert_allclose(got, want, rtol=1e-5)
                else:
                    np.testing.assert_allclose(got, want, atol=1e-5,
                                               rtol=1e-5)


@pytest.mark.parametrize("plan_key", ["local", "prism@9.9"])
def test_greedy_generate_token_exact(sessions, plan_key):
    js, ts = sessions
    prompt = _tokens(3, 3, 7, js.cfg.vocab_size)
    want = np.asarray(js.generate(prompt, 9, plan=js.plans[plan_key]))
    got = ts.generate(torch.from_numpy(prompt), 9, plan=ts.plans[plan_key])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
