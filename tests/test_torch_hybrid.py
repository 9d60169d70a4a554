"""The recurrent families' models in the port against the JAX package at
reduced size in f32 — hymba-1.5b (hybrid: attention ‖ Mamba heads, two
layers, 4/2 heads, no ``fuse`` since 4·16 = d) and xlstm-350m (ssm: one
group of one mLSTM and one sLSTM block) — the JAX weights carried across
by the params bridge:

* the bridge: hymba's ``fuse`` None carried as None (and a zero ``fuse``
  where ``n_heads·hd ≠ d``), xLSTM's nested ``groups`` → ``mlstm`` and
  ``m_ln`` lists, bit for bit; the port's own init has the JAX layout;
* ``forward_lm`` logits (≤ 2e-3, ``last_only`` included); each
  ``decode_step`` from the JAX cache before it (≤ 1e-4), the cache after
  it equal to JAX's; a ``[B]`` cache index (the slot pool's step);
* the decode-loop prefill (no single-pass prefill in either package);
  greedy ``generate`` token-exact; the slot pool token-exact against the
  JAX package's ``ServingRuntime`` and B 1 ``generate``, a slot
  re-admitted, and a re-admitted row holding the new request's primed
  state;
* ``cache_batch_axes`` equal to the JAX package's (axis 2 for xLSTM's
  mLSTM states), the cache layout, the partitioned cache, ``input_specs``
  and ``weight_bytes``; the session's simulated profile, decide and
  dispatch, and a measured profile on the CPU;
* hymba at ``n_heads·hd ≠ d``: refused in both packages (the JAX
  package's layer raises; the port refuses the config).
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

ARCHS = ("hymba-1.5b", "xlstm-350m")
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


def _np_tree(tree):
    """Port params or cache → the JAX package's stacked layout in numpy:
    every stack of ``layer_stacks`` stacked back (its inner stacks
    first), None kept."""
    def leaves(t):
        if isinstance(t, dict):
            return {k: leaves(v) for k, v in t.items()}
        if isinstance(t, list):
            return jax.tree.map(lambda *ls: np.stack(ls), *map(leaves, t))
        return None if t is None else t.numpy()
    return leaves(tree)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_configs_are_the_jax_packages():
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    for arch in ARCHS:
        assert dataclasses.asdict(tget(arch)) == dataclasses.asdict(jget(arch))
    h, x = tget(ARCHS[0]), tget(ARCHS[1])
    assert (h.family, h.n_heads, h.n_kv_heads, h.hd, h.ssm.state_size) == \
        ("hybrid", 25, 5, 64, 16)
    assert h.n_heads * h.hd == h.d_model         # no fuse at full width
    assert (x.family, x.n_layers // x.ssm.slstm_every,
            x.ssm.slstm_every - 1) == ("ssm", 3, 7)


def test_bridge_carries_none_leaves_and_nested_groups(sessions):
    js, ts = sessions
    if js.cfg.family == "hybrid":
        assert js.params["layers"]["fuse"] is None
        assert all(lp["fuse"] is None for lp in ts.params["layers"])
        np.testing.assert_array_equal(
            ts.params["layers"][1]["mamba"]["a_log"].numpy(),
            np.asarray(js.params["layers"]["mamba"]["a_log"][1]))
    else:
        n_m = js.cfg.ssm.slstm_every - 1
        g = ts.params["groups"][0]
        assert isinstance(g["mlstm"], list) and len(g["mlstm"]) == n_m
        assert len(g["m_ln"]) == n_m
        np.testing.assert_array_equal(
            g["mlstm"][0]["w_q"].numpy(),
            np.asarray(js.params["groups"]["mlstm"]["w_q"][0, 0]))
        np.testing.assert_array_equal(
            g["slstm"]["r"].numpy(),
            np.asarray(js.params["groups"]["slstm"]["r"][0]))
    back = _np_tree(ts.params)
    want = jax.tree.map(np.asarray, js.params)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_bridge_carries_a_zero_fuse():
    from repro.models import registry as jreg
    from repro.configs import get_config as jget
    cfg = jget(ARCHS[0]).reduced(dtype="float32", head_dim=8)
    p = jax.tree.map(np.asarray, jreg.init_params(cfg, 0))
    tp = params_from_numpy(p, cfg)
    assert [tuple(lp["fuse"].shape) for lp in tp["layers"]] == [(32, 64)] * 2
    assert all(not lp["fuse"].any() for lp in tp["layers"])


def test_init_lm_has_the_jax_packages_layout(sessions):
    """The port's own initialisation gives every leaf of the JAX params
    with its shape and dtype, and None where the JAX package has None."""
    from repro_torch.models import registry
    js, ts = sessions
    mine = _np_tree(registry.init_params(ts.cfg, seed=0, device="cpu"))

    def layout(t):
        return {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
                for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    assert layout(mine) == layout(js.params)
    assert jax.tree.structure(mine) == jax.tree.structure(
        jax.tree.map(np.asarray, js.params))


def test_forward_logits_match(sessions):
    js, ts = sessions
    toks = _tokens(1, 2, 24, js.cfg.vocab_size)
    xj = JPlan.local().to_exchange_config()
    xt = TPlan.local().to_exchange_config()
    lj, _ = jtfm.forward_lm(js.params, {"tokens": jnp.asarray(toks)}, js.cfg,
                            xj)
    with torch.inference_mode():
        lt, aux = ttfm.forward_lm(ts.params,
                                  {"tokens": torch.from_numpy(toks)}, ts.cfg,
                                  xt)
        last = ttfm.forward_lm(ts.params, {"tokens": torch.from_numpy(toks)},
                               ts.cfg, xt, last_only=True)[0]
    assert lt.shape == (2, 24, js.cfg.vocab_size) and float(aux) == 0.0
    assert _diff(lt.numpy(), lj) <= FWD_TOL
    assert _diff(last.numpy(), np.asarray(lj)[:, -1:]) <= FWD_TOL
    got = ts.run("local", {"tokens": torch.from_numpy(toks)}).numpy()
    assert _diff(got, lj) <= FWD_TOL


def test_decode_step_logits_and_cache_match(sessions):
    """Each decode step from the JAX cache after the steps before it:
    logits within 1e-4, and the cache after it (KV at the written
    position, every recurrent state) the JAX package's."""
    js, ts = sessions
    B, S = 2, 12
    toks = _tokens(2, B, S, js.cfg.vocab_size)
    xj = JPlan.local().to_exchange_config()
    xt = TPlan.local().to_exchange_config()
    jcache = jtfm.init_decode_cache(js.cfg, B, S)
    with torch.inference_mode():
        for t in range(S):
            tcache = _to_torch(jcache)
            lj, jcache = jtfm.decode_step(
                js.params, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jcache,
                t, js.cfg, xj)
            lt, tcache = ttfm.decode_step(
                ts.params, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
                tcache, t, ts.cfg, xt)
            assert _diff(lt.numpy(), lj) <= STEP_TOL
            for a, b in zip(jax.tree.leaves(_np_tree(tcache)),
                            jax.tree.leaves(jcache)):
                b = np.asarray(b)
                assert a.shape == b.shape and a.dtype == b.dtype
                assert _diff(a, b) <= MOD_TOL * max(1.0, np.abs(b).max())


def test_per_row_decode_matches_per_row_jax_steps(sessions):
    """A ``[B]`` cache index (the slot pool's step): row b decodes at its
    own position from its own recurrent state, as the JAX package's B 1
    step on that row's cache."""
    js, ts = sessions
    B, S = 3, 10
    toks = _tokens(4, B, S, js.cfg.vocab_size)
    xj = JPlan.local().to_exchange_config()
    xt = TPlan.local().to_exchange_config()
    lens = [4, 9, 1]
    axes = jax.tree.leaves(_batch_axes(js.cfg))
    rows = []
    for b in range(B):
        c = jtfm.init_decode_cache(js.cfg, 1, S)
        for t in range(lens[b]):
            _, c = jtfm.decode_step(
                js.params, {"tokens": jnp.asarray(toks[b:b + 1, t:t + 1])},
                c, t, js.cfg, xj)
        rows.append(c)
    struct = jax.tree.structure(rows[0])
    tcache = _to_torch(jax.tree.unflatten(struct, [
        np.concatenate([np.array(jax.tree.leaves(r)[i]) for r in rows],
                       axis=a) for i, a in enumerate(axes)]))
    nxt = np.stack([toks[b, lens[b]:lens[b] + 1] for b in range(B)])
    with torch.inference_mode():
        lt, _ = ttfm.decode_step(ts.params, {"tokens": torch.from_numpy(nxt)},
                                 tcache, torch.tensor(lens), ts.cfg, xt)
    for b in range(B):
        lj, _ = jtfm.decode_step(js.params,
                                 {"tokens": jnp.asarray(nxt[b:b + 1])},
                                 rows[b], lens[b], js.cfg, xj)
        assert _diff(lt[b:b + 1].numpy(), lj) <= STEP_TOL


def _batch_axes(jcfg):
    from repro.api import generation as jgen
    return jgen.cache_batch_axes(jcfg)


def test_prefill_is_the_decode_loop_in_both_packages(sessions):
    from repro.api import generation as jgen
    from repro_torch.api import generation as tgen
    js, ts = sessions
    assert not ttfm.supports_prefill(ts.cfg)
    assert not jtfm.supports_prefill(js.cfg)
    for plan in ("local", "voltage"):
        xj = getattr(JPlan, plan)().to_exchange_config()
        xt = getattr(TPlan, plan)().to_exchange_config()
        assert tgen.resolve_prefill_mode(ts.cfg, xt) == \
            jgen.resolve_prefill_mode(js.cfg, xj) == "scan"
    with pytest.raises(ValueError, match="no single-pass prefill"):
        tgen.resolve_prefill_mode(ts.cfg, TPlan.local().to_exchange_config(),
                                  "single_pass")


def test_greedy_generate_token_exact(sessions):
    js, ts = sessions
    prompt = _tokens(3, 3, 9, js.cfg.vocab_size)
    want = np.asarray(js.generate(prompt, 12, plan=js.plans["local"]))
    got = ts.generate(torch.from_numpy(prompt), 12, plan=ts.plans["local"])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_slot_pool_serves_token_exact_against_the_jax_runtime(sessions):
    """Greedy tokens of every request served through the port's slot pool
    (2 slots, 3 requests: one slot re-admitted) equal the JAX package's
    ``ServingRuntime`` on the same weights, and its B=1 ``generate``."""
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


def test_readmitted_slot_holds_the_new_requests_state(sessions):
    """Admission copies the whole row: after a slot decoded one request,
    admitting another leaves in that row exactly the new request's primed
    cache, recurrent states included, and the other row untouched."""
    from repro_torch.api import generation as tgen
    _, ts = sessions
    cfg = ts.cfg
    pool = ts.init_slot_pool(2, 24)
    tok = torch.zeros(2, dtype=torch.int32)
    lengths = torch.zeros(2, dtype=torch.long)
    gens, temps = [None, None], [0.0, 0.0]
    admit = tgen.build_admit_fn(cfg)
    chunk = tgen.build_decode_chunk_fn(cfg, TPlan.local().to_exchange_config(),
                                       n_steps=3, max_len=24)
    for i, T0 in enumerate((5, 7)):
        t0, c, g = ts.prime_slot(_tokens(10 + i, 1, T0, cfg.vocab_size),
                                 total_len=24)
        admit(pool, tok, lengths, gens, temps, c, i, t0, T0, g, 0.0)
    _, pool, lengths, gens = chunk(ts.params, pool, tok, lengths, gens, temps)
    other = _np_tree(pool)
    t0, new, g = ts.prime_slot(_tokens(12, 1, 4, cfg.vocab_size),
                               total_len=24)
    admit(pool, tok, lengths, gens, temps, new, 0, t0, 4, g, 0.0)
    axes = jax.tree.leaves(tgen.cache_batch_axes(cfg))
    for got, want, before, a in zip(jax.tree.leaves(_np_tree(pool)),
                                    jax.tree.leaves(_np_tree(new)),
                                    jax.tree.leaves(other), axes):
        np.testing.assert_array_equal(np.take(got, 0, axis=a),
                                      np.take(want, 0, axis=a))
        np.testing.assert_array_equal(np.take(got, 1, axis=a),
                                      np.take(before, 1, axis=a))


def test_cache_layout_and_input_specs(sessions):
    from repro.configs.base import ShapeSpec as JShape
    from repro.models import registry as jreg
    from repro_torch.api.generation import cache_batch_axes
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import registry
    js, ts = sessions
    cfg = ts.cfg
    axes = cache_batch_axes(cfg)
    assert axes == _batch_axes(js.cfg)
    if cfg.family == "ssm":
        assert axes == {"m": {"C": 2, "n": 2, "m": 2},
                        "s": {"c": 1, "n": 1, "h": 1, "m": 1}}
    else:
        assert axes == {"kv": {"k": 1, "v": 1}, "ssm": {"h": 1, "conv": 1}}
    jc = jtfm.init_decode_cache(js.cfg, 3, 26)
    tc = ttfm.init_decode_cache(cfg, 3, 26, device="cpu")
    for a, b in zip(jax.tree.leaves(_np_tree(tc)), jax.tree.leaves(jc)):
        assert a.shape == b.shape and a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    xcfg = TPlan.voltage(seq_shards=4).to_exchange_config()
    part = ttfm.init_decode_cache(cfg, 3, 26, device="cpu", xcfg=xcfg)
    if cfg.family == "hybrid":           # KV in blocks, the state whole
        assert part["kv"]["k"].shape[:3] == (cfg.n_layers, 3, 7)
        assert part["ssm"]["h"].shape == tc["ssm"]["h"].shape
    else:
        assert _np_tree(part)["m"]["C"].shape == tc["m"]["C"].shape
    for kind in ("prefill", "decode", "train"):
        want = jreg.input_specs(js.cfg, JShape("s", 48, 3, kind))
        got = registry.input_specs(cfg, ShapeSpec("s", 48, 3, kind))
        assert {k: tuple(s.shape) for k, s in want.items()} == {
            k: tuple(s.shape) for k, s in got.items()}


@pytest.mark.parametrize("arch,over", [
    ("hymba-1.5b", {}),
    ("hymba-1.5b", {"n_heads": 2, "n_kv_heads": 1, "head_dim": 32}),
    ("hymba-1.5b", {"dtype": "bfloat16"}), ("xlstm-350m", {}),
    ("xlstm-350m", {"dtype": "bfloat16"})])
def test_weight_bytes_count_what_init_draws(arch, over):
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    cfg = get_config(arch).reduced(**{**REDUCED, **over})
    drawn = sum(t.numel() * t.element_size() for t in jax.tree.leaves(
        registry.init_params(cfg, seed=0, device="cpu")))
    assert registry.weight_bytes(cfg) == drawn
    full = registry.weight_bytes(get_config(arch))
    assert (3.8e9 < full < 3.9e9) if arch == ARCHS[0] else \
        (0.9e9 < full < 1.0e9)


def test_session_profiles_decides_and_dispatches(sessions):
    """The simulated profile, decide and dispatch of the JAX package's
    session, on the port's arch with its ``local`` plan; then a measured
    profile of the port on the CPU."""
    from repro_torch.profiling import SweepSpec
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
    pm = ts.profile(SweepSpec(batches=(1, 2), crs=(9.9,),
                              bandwidths_mbps=(400.0,), warmup_runs=1),
                    backend="measured", iters=1, warmup=1, seq_len=16)
    assert len(pm) == 2 and all(e.total_ms > 0 for _, e in pm.entries())


def test_hymba_fuse_path_decodes_as_it_forwards():
    """Where ``n_heads·hd ≠ d`` neither package runs hymba: the JAX
    package's forward and decode raise (its ``attn_norm`` is
    ``n_heads·hd`` wide and meets the d-wide ``wo`` output, so its
    ``fuse`` is never reached), and the port refuses the config when it
    draws weights, builds a cache, forwards and decodes, the JAX
    package's weights (a zero ``fuse``) carried across included."""
    from repro.models import registry as jreg
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    jcfg = jget(ARCHS[0]).reduced(dtype="float32", head_dim=8)
    jp = jreg.init_params(jcfg, 0)
    jx = JPlan.local().to_exchange_config()
    with pytest.raises(ValueError, match="broadcast"):
        jtfm.forward_lm(jp, {"tokens": jnp.zeros((1, 4), jnp.int32)}, jcfg,
                        jx)
    jcache = jtfm.init_decode_cache(jcfg, 1, 4)
    with pytest.raises(ValueError, match="broadcast"):
        jtfm.decode_step(jp, {"tokens": jnp.zeros((1, 1), jnp.int32)},
                         jcache, 0, jcfg, jx)
    cfg = get_config(ARCHS[0]).reduced(dtype="float32", head_dim=8)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), jcfg)
    xt = TPlan.local().to_exchange_config()
    toks = torch.zeros((1, 4), dtype=torch.int32)
    refused = "n_heads·hd == d_model"
    with pytest.raises(ValueError, match=refused):
        registry.init_params(cfg, seed=1, device="cpu")
    with pytest.raises(ValueError, match=refused):
        ttfm.init_decode_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match=refused):
        ttfm.forward_lm(params, {"tokens": toks}, cfg, xt)
    with pytest.raises(ValueError, match=refused):
        ttfm.decode_step(params, {"tokens": toks[:, :1]}, {}, 0, cfg, xt)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_serves_the_family(arch, capsys):
    """``repro_torch.launch.serve --arch`` serves the reduced arch through
    the slot pool."""
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--arch", arch, "--mode", "local",
                "--requests", "3", "--batch", "2", "--tokens", "3",
                "--prompt-len", "6"])
    assert "SERVE OK" in capsys.readouterr().out
