"""The moe family in the port against the JAX package at reduced size in
f32 (deepseek-moe-16b: GQA attention; deepseek-v2-236b: MLA attention;
both: one dense first layer and one layer of 4 routed top-2 experts and
a shared one), the JAX weights carried across by the params bridge:

* the configs: field for field the JAX package's, full and reduced;
* ``apply_moe`` against the JAX ``apply_moe`` on the same weights: the
  output and the aux loss within 1e-5, with and without dropped (token,
  choice) pairs (a capacity factor low enough that some expert overflows;
  the drops are counted from the JAX routing), the 4096-token regroup at
  S 8192, and one-token decode;
* the bridge: ``first_layers`` and ``layers`` unstacked bit for bit;
* ``forward_lm`` logits under ``local`` (≤ 2e-3, ``last_only`` included)
  and its summed aux loss;
* ``decode_step`` logits, each step from the JAX cache before it: ≤ 1e-4,
  and the position each step writes (K/V, or MLA's latent);
* the opt-in single-pass ``prefill`` (twin of
  ``tests/test_generation.py::test_moe_single_pass_prefill_matches_forward``)
  and ``auto`` keeping the decode loop, as in the JAX package;
* greedy ``generate`` token-exact; the dense slot pool serving
  token-exact against the JAX package's ``ServingRuntime``; the paged pool
  refusing the family in both packages;
* ``input_specs``, ``cache_batch_axes``, the partitioned cache layout and
  the session's simulated profile, decide and dispatch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecutionPlan as JPlan
from repro.api import InferenceSession as JSession
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch.api import ExecutionPlan as TPlan
from repro_torch.api import InferenceSession as TSession
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.models.bridge import params_from_numpy, tensor_from_numpy

ARCHS = ("deepseek-moe-16b", "deepseek-v2-236b")
REDUCED = {"dtype": "float32"}
FWD_TOL, STEP_TOL, MOD_TOL = 2e-3, 1e-4, 1e-5


def _pair(arch, reduced=REDUCED):
    """(JAX session, port session) over the same f32 weights."""
    js = JSession.from_config(arch, plans=[JPlan.local()], reduced=reduced,
                              seed=0)
    tparams = params_from_numpy(jax.tree.map(np.asarray, js.params), js.cfg,
                                device="cpu")
    ts = TSession.from_config(arch, plans=[TPlan.local()], reduced=reduced,
                              params=tparams, device="cpu")
    return js, ts


@pytest.fixture(scope="module", params=ARCHS)
def sessions(request):
    return _pair(request.param)


def _tokens(seed, B, T, vocab):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, T)
                                               ).astype(np.int32)


def _diff(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_jax_packages(arch):
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    assert dataclasses.asdict(tget(arch)) == dataclasses.asdict(jget(arch))
    reduced = tget(arch).reduced(**REDUCED)
    assert dataclasses.asdict(reduced) == dataclasses.asdict(
        jget(arch).reduced(**REDUCED))
    assert reduced.family == "moe" and reduced.n_layers == 2
    assert reduced.moe.first_dense_layers == 1
    assert (reduced.mla is not None) == (arch == "deepseek-v2-236b")


# --- apply_moe ---------------------------------------------------------------

def _moe_weights(d, cfg, seed):
    """The JAX ``init_moe`` at width d (numpy leaves) and the same weights
    in the port."""
    p = jax.tree.map(np.asarray,
                     jmoe.init_moe(jax.random.PRNGKey(seed), d, cfg,
                                   jnp.float32))
    return p, jax.tree.map(tensor_from_numpy, p)


def _dropped(p, x, cfg):
    """(token, choice) pairs the JAX routing drops, counted in numpy from
    its own top-k: per group, the number of earlier selections of the
    chosen expert (token-then-choice order) at or past the capacity."""
    G0, S0, D = x.shape
    GS = jmoe.GROUP_TOKENS if (S0 > jmoe.GROUP_TOKENS
                               and S0 % jmoe.GROUP_TOKENS == 0) else S0
    xs = jnp.asarray(x).reshape(-1, GS, D)
    probs = jax.nn.softmax(xs.astype(jnp.float32) @ p["router"], axis=-1)
    top_i = np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])
    C = jmoe.expert_capacity(GS, cfg)
    dropped = 0
    for g in top_i:
        seen = np.zeros(cfg.n_experts, np.int64)
        for e in g.reshape(-1):
            dropped += seen[e] >= C
            seen[e] += 1
    return dropped


# label → (G, S, capacity factor): no drops; drops; the 4096-token regroup
# (two groups a row) with drops; one-token decode
MOE_CASES = {"fits": (2, 24, 4.0), "drops": (2, 48, 0.5),
             "regroup": (1, 8192, 0.8), "decode": (4, 1, 1.25)}


@pytest.mark.parametrize("label", sorted(MOE_CASES))
def test_apply_moe_matches_jax(label):
    from repro.configs import get_config as jget
    G, S, cf = MOE_CASES[label]
    d = 32
    cfg = dataclasses.replace(jget("deepseek-moe-16b").reduced().moe,
                              capacity_factor=cf)
    p, tp = _moe_weights(d, cfg, seed=1)
    x = np.random.RandomState(2).randn(G, S, d).astype(np.float32)
    yj, aj = jmoe.apply_moe(p, jnp.asarray(x), cfg)
    yt, at = tmoe.apply_moe(tp, torch.from_numpy(x), cfg)
    assert yt.shape == (G, S, d) and yt.dtype == torch.float32
    assert _diff(yt.numpy(), yj) <= MOD_TOL
    assert abs(float(at) - float(aj)) <= MOD_TOL * abs(float(aj))
    drops = _dropped(p, x, cfg)
    assert (drops > 0) == (label in ("drops", "regroup"))
    if label == "regroup":
        assert tmoe.group_length(S) == tmoe.GROUP_TOKENS


def test_apply_moe_drops_change_the_output():
    """The drops the JAX package makes are the port's: with the capacity
    raised so nothing drops, both outputs move, and by the same amount."""
    from repro.configs import get_config as jget
    base = jget("deepseek-moe-16b").reduced().moe
    x = np.random.RandomState(3).randn(2, 48, 32).astype(np.float32)
    out = {}
    for cf in (0.5, 8.0):
        cfg = dataclasses.replace(base, capacity_factor=cf)
        p, tp = _moe_weights(32, cfg, seed=1)
        out[cf] = (np.asarray(jmoe.apply_moe(p, jnp.asarray(x), cfg)[0]),
                   tmoe.apply_moe(tp, torch.from_numpy(x), cfg)[0].numpy())
    assert _diff(out[0.5][0], out[8.0][0]) > 1e-3
    assert _diff(out[0.5][0] - out[8.0][0],
                 out[0.5][1] - out[8.0][1]) <= MOD_TOL


# --- the model ---------------------------------------------------------------

def test_bridge_unstacks_both_stacks(sessions):
    js, ts = sessions
    fd = js.cfg.moe.first_dense_layers
    assert len(ts.params["first_layers"]) == fd
    assert len(ts.params["layers"]) == js.cfg.n_layers - fd
    assert "mlp" in ts.params["first_layers"][0]
    assert "moe" in ts.params["layers"][0]
    np.testing.assert_array_equal(
        ts.params["layers"][0]["moe"]["w_gate"].numpy(),
        np.asarray(js.params["layers"]["moe"]["w_gate"][0]))
    np.testing.assert_array_equal(
        ts.params["first_layers"][0]["attn"]["wo"].numpy(),
        np.asarray(js.params["first_layers"]["attn"]["wo"][0]))


def test_init_lm_has_the_jax_packages_layout(sessions):
    """The port's own initialisation gives every leaf of the JAX params
    with its shape and dtype."""
    from repro_torch.models import registry
    js, ts = sessions
    mine = registry.init_params(ts.cfg, seed=0, device="cpu")
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
            for k, v in jax.tree_util.tree_flatten_with_path(js.params)[0]}
    got = {}
    for name, v in mine.items():
        if isinstance(v, list):
            stacked = jax.tree.map(lambda *ls: np.stack(ls),
                                   *jax.tree.map(lambda t: t.numpy(), v))
            v = stacked
        else:
            v = jax.tree.map(lambda t: t.numpy(), v)
        for k, leaf in jax.tree_util.tree_flatten_with_path({name: v})[0]:
            got[jax.tree_util.keystr(k)] = (tuple(leaf.shape),
                                            str(leaf.dtype))
    assert got == want


def test_forward_logits_and_aux_match(sessions):
    js, ts = sessions
    toks = _tokens(1, 2, 24, js.cfg.vocab_size)
    xj = JPlan.local().to_exchange_config()
    xt = TPlan.local().to_exchange_config()
    lj, aj = jtfm.forward_lm(js.params, {"tokens": jnp.asarray(toks)},
                             js.cfg, xj)
    with torch.inference_mode():
        lt, at = ttfm.forward_lm(ts.params, {"tokens": torch.from_numpy(toks)},
                                 ts.cfg, xt)
        last_t = ttfm.forward_lm(ts.params,
                                 {"tokens": torch.from_numpy(toks)}, ts.cfg,
                                 xt, last_only=True)[0]
    assert lt.shape == (2, 24, js.cfg.vocab_size)
    assert _diff(lt.numpy(), lj) <= FWD_TOL
    assert _diff(last_t.numpy(), np.asarray(lj)[:, -1:]) <= FWD_TOL
    assert float(aj) > 0 and abs(float(at) - float(aj)) <= MOD_TOL * float(aj)
    got = ts.run("local", {"tokens": torch.from_numpy(toks)}).numpy()
    assert _diff(got, lj) <= FWD_TOL


def _leaf_names(cfg):
    return ("c_kv", "k_pe") if cfg.mla is not None else ("k", "v")


def test_decode_step_logits_match(sessions):
    """Each decode step from the JAX cache after the steps before it:
    logits within 1e-4, and the position the step writes in both halves
    of the cache the JAX package's."""
    js, ts = sessions
    B, S = 2, 12
    toks = _tokens(2, B, S, js.cfg.vocab_size)
    xj = JPlan.local().to_exchange_config()
    xt = TPlan.local().to_exchange_config()
    jcache = jtfm.init_decode_cache(js.cfg, B, S)
    assert set(jcache) == {"first", "kv"}
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
            for half in ("first", "kv"):
                for name in _leaf_names(ts.cfg):
                    assert _diff(tcache[half][name][:, :, t].numpy(),
                                 np.asarray(jcache[half][name][:, :, t])
                                 ) <= MOD_TOL


def test_per_row_decode_matches_per_row_jax_steps(sessions):
    """A ``[B]`` cache index (the slot pool's step): row b decodes at its
    own position, as the JAX package's B 1 step at that position on that
    row's cache."""
    js, ts = sessions
    B, S = 3, 10
    toks = _tokens(4, B, S, js.cfg.vocab_size)
    xj = JPlan.local().to_exchange_config()
    xt = TPlan.local().to_exchange_config()
    lens = [4, 9, 1]
    rows = []
    for b in range(B):
        c = jtfm.init_decode_cache(js.cfg, 1, S)
        for t in range(lens[b]):
            _, c = jtfm.decode_step(js.params,
                                    {"tokens": jnp.asarray(toks[b:b + 1,
                                                                t:t + 1])},
                                    c, t, js.cfg, xj)
        rows.append(c)
    tcache = {half: {n: torch.from_numpy(np.concatenate(
        [np.array(r[half][n]) for r in rows], axis=1))
        for n in _leaf_names(ts.cfg)} for half in ("first", "kv")}
    nxt = np.stack([toks[b, lens[b]:lens[b] + 1] for b in range(B)])
    with torch.inference_mode():
        lt, _ = ttfm.decode_step(ts.params, {"tokens": torch.from_numpy(nxt)},
                                 tcache, torch.tensor(lens), ts.cfg, xt)
    for b in range(B):
        lj, _ = jtfm.decode_step(js.params,
                                 {"tokens": jnp.asarray(nxt[b:b + 1])},
                                 rows[b], lens[b], js.cfg, xj)
        assert _diff(lt[b:b + 1].numpy(), lj) <= STEP_TOL


def test_single_pass_prefill_matches_the_forward_and_jax(sessions):
    """Twin of the JAX package's ``test_moe_single_pass_prefill_matches_
    forward``: the opt-in single-pass prefill's logits are the forward's
    last position and the JAX package's, and its cache is JAX's."""
    js, ts = sessions
    prompt = _tokens(7, 1, 6, js.cfg.vocab_size)
    xj = JPlan.local().to_exchange_config()
    xt = TPlan.local().to_exchange_config()
    jcache = jtfm.init_decode_cache(js.cfg, 1, 8)
    lj, jcache = jtfm.prefill(js.params, {"tokens": jnp.asarray(prompt)},
                              jcache, js.cfg, xj)
    with torch.inference_mode():
        cache = ttfm.init_decode_cache(ts.cfg, 1, 8, device="cpu")
        lt, cache = ttfm.prefill(ts.params,
                                 {"tokens": torch.from_numpy(prompt)}, cache,
                                 ts.cfg, xt)
        full, _ = ttfm.forward_lm(ts.params,
                                  {"tokens": torch.from_numpy(prompt)},
                                  ts.cfg, xt)
    np.testing.assert_allclose(lt[:, 0].numpy(), full[:, -1].numpy(),
                               atol=1e-5, rtol=1e-5)
    assert _diff(lt.numpy(), lj) <= FWD_TOL
    for half in ("first", "kv"):
        for name in _leaf_names(ts.cfg):
            assert _diff(cache[half][name].numpy(),
                         jcache[half][name]) <= MOD_TOL


def test_prefill_mode_auto_keeps_the_decode_loop(sessions):
    from repro.api import generation as jgen
    from repro_torch.api import generation as tgen
    js, ts = sessions
    assert ttfm.supports_prefill(ts.cfg) and jtfm.supports_prefill(js.cfg)
    for plan in ("local", "voltage"):
        xj = getattr(JPlan, plan)().to_exchange_config()
        xt = getattr(TPlan, plan)().to_exchange_config()
        assert tgen.resolve_prefill_mode(ts.cfg, xt) == \
            jgen.resolve_prefill_mode(js.cfg, xj) == "scan"
        assert tgen.resolve_prefill_mode(ts.cfg, xt, "single_pass") == \
            "single_pass"


@pytest.mark.parametrize("mode", ["auto", "single_pass"])
def test_greedy_generate_token_exact(sessions, mode):
    js, ts = sessions
    prompt = _tokens(3, 3, 9, js.cfg.vocab_size)
    want = np.asarray(js.generate(prompt, 12, plan=js.plans["local"],
                                  prefill_mode=mode))
    got = ts.generate(torch.from_numpy(prompt), 12, plan=ts.plans["local"],
                      prefill_mode=mode)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_slot_pool_serves_token_exact_against_the_jax_runtime(sessions):
    """Greedy tokens of every request served through the port's dense slot
    pool equal the JAX package's ``ServingRuntime`` on the same weights,
    and its B=1 ``generate``."""
    from repro.serving import ServingRuntime as JRuntime
    from repro_torch.serving import ServingRuntime as TRuntime
    js, ts = sessions
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, js.cfg.vocab_size, n) for n in (5, 11, 3)]
    out = []
    for sess, runtime in ((js, JRuntime), (ts, TRuntime)):
        sess.profile(backend="simulated")
        rt = runtime(sess, n_slots=2, chunk=4, max_len=32)
        reqs = [rt.submit(p, 10, seed=i) for i, p in enumerate(prompts)]
        done = {c.request_id: np.asarray(c.tokens) for c in rt.run()}
        out.append([done[r.id] for r in reqs])
    for p, w, g in zip(prompts, *out):
        np.testing.assert_array_equal(g, w)
        ref = np.asarray(js.generate(np.asarray(p, np.int32)[None], 10))[0]
        np.testing.assert_array_equal(g, ref)


def test_paged_pool_refuses_the_family_in_both_packages(sessions):
    js, ts = sessions
    assert not ttfm.supports_page_pool(ts.cfg)
    assert not jtfm.supports_page_pool(js.cfg)
    with pytest.raises(ValueError, match="no paged decode path"):
        ttfm.init_page_pool(ts.cfg, 8, 4, device="cpu")
    with pytest.raises(ValueError, match="no paged decode path"):
        jtfm.init_page_pool(js.cfg, 8, 4)


def test_cache_layout_and_input_specs(sessions):
    from repro.configs.base import ShapeSpec as JShape
    from repro.models import registry as jreg
    from repro_torch.api.generation import cache_batch_axes
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import registry
    js, ts = sessions
    cfg = ts.cfg
    names = _leaf_names(cfg)
    assert cache_batch_axes(cfg) == {half: {n: 1 for n in names}
                                     for half in ("first", "kv")}
    jc = jtfm.init_decode_cache(js.cfg, 3, 26)
    tc = ttfm.init_decode_cache(cfg, 3, 26, device="cpu")
    for half in ("first", "kv"):
        for n in names:
            assert tc[half][n].shape == jc[half][n].shape
    xcfg = TPlan.voltage(seq_shards=4).to_exchange_config()
    part = ttfm.init_decode_cache(cfg, 3, 26, device="cpu", xcfg=xcfg)
    assert part["kv"][names[0]].shape[:3] == (cfg.n_layers - 1, 3, 7)
    for kind in ("prefill", "decode", "train"):
        want = jreg.input_specs(js.cfg, JShape("s", 48, 3, kind))
        got = registry.input_specs(cfg, ShapeSpec("s", 48, 3, kind))
        assert {k: tuple(s.shape) for k, s in want.items()} == {
            k: tuple(s.shape) for k, s in got.items()}
    pool = ts.init_slot_pool(2, 16)
    assert set(pool) == {"first", "kv"}


def test_session_profiles_decides_and_dispatches(sessions):
    """The simulated profile, decide and dispatch of the JAX package's
    session, on the port's moe arch with its ``local`` plan."""
    js, ts = _pair(sessions[0].cfg.name)
    for s in (js, ts):
        s.profile(backend="simulated")
    for B in (1, 8, 32):
        dt, dj = ts.decide(B), js.decide(B)
        assert (dt.mode, dt.cr, dt.codec) == (dj.mode, dj.cr, dj.codec)
        assert dt.expected.total_ms == dj.expected.total_ms
    toks = _tokens(6, 2, 16, js.cfg.vocab_size)
    got = ts.dispatch({"tokens": torch.from_numpy(toks)})
    want = np.asarray(js.run("local", {"tokens": toks}))
    assert _diff(got.numpy(), want) <= FWD_TOL


def test_families_still_to_port_raise_naming_the_roadmap():
    """No family is left to port: every arch of the JAX package's config
    registry has a port config equal field for field, and only a family
    neither package has is refused."""
    from repro.configs import _MODULES as jmodules
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config
    for arch in jmodules:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget(arch))
    assert get_config("hymba-1.5b").family == "hybrid"
    assert get_config("xlstm-350m").family == "ssm"
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("mamba-2.8b")
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              family="rnn")
    with pytest.raises(NotImplementedError, match="no decoder stack"):
        ttfm.init_decode_cache(cfg, 1, 4)


def test_serve_launcher_serves_the_family_and_refuses_what_does_not_fit(
        capsys):
    """``repro_torch.launch.serve`` serves the reduced deepseek-moe-16b
    through the slot pool, and refuses deepseek-v2-236b at ``--full``
    (472 GB of weights), naming the sizes."""
    from repro_torch.launch import serve
    from repro_torch.configs import get_config
    from repro_torch.models.registry import weight_bytes
    assert 30e9 < weight_bytes(get_config("deepseek-moe-16b")) < 40e9
    assert weight_bytes(get_config("deepseek-v2-236b")) > 400e9
    serve.main(["--device", "cpu", "--arch", "deepseek-moe-16b", "--mode",
                "local", "--requests", "2", "--batch", "2", "--tokens", "3",
                "--prompt-len", "6"])
    assert "SERVE OK" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="do not fit one device"):
        serve.main(["--device", "cpu", "--arch", "deepseek-v2-236b",
                    "--full"])
