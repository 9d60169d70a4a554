"""The audio (whisper-large-v3) and vlm (llama-3.2-vision-11b) families in
the port against the JAX package at reduced size in f32, one process, the
JAX weights carried across by the params bridge:

* the configs: field for field the JAX package's, full and reduced;
* the bridge: whisper's ``enc_layers`` and ``dec_layers``, the vlm's
  doubly stacked ``self_layers`` (one list, group by group) and its
  ``cross_layers`` (``gate`` an f32 scalar), bit for bit;
* ``_memory_kv``, ``_encode_audio``, ``_image_memory``, ``prefill_memory``
  and ``_cross_attend`` (full-sequence queries and one decode token, over
  a padded memory under its mask) within 1e-5;
* ``forward_lm`` logits under ``local`` and ``prism_sim`` (13 frames or
  11 image tokens, padded to 16 or 12 under ``prism_sim``), ``last_only``
  included, ≤ 2e-3; single-pass ``prefill`` logits and decode steps
  (each from the JAX cache before it, over the padded memory) ≤ 1e-4;
* greedy ``session.generate`` with ``batch_extras`` under ``local`` and
  ``prism_sim``, both prefill modes, token-exact.  The JAX package's
  ``prism_sim`` decode sends the cross-attention token to the VOLTAGE
  ``shard_map``, which needs a mesh; with none its oracle attends the
  memory it holds whole, which is what that exact merge computes;
* a nonzero vlm ``gate`` moves the logits (it is set to 0.5 on both
  sides throughout: the reference's zero gate erases the cross-attention);
* ``input_specs``, the decode cache's layout, ``weight_bytes``, the
  session's measured profile and ``dispatch`` on the CPU, and the slot
  pool's refusal, named as in the JAX package.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecutionPlan as JPlan
from repro.api import InferenceSession as JSession
from repro.core import exchange as jx
from repro.models import transformer as jtfm
from repro_torch.api import ExecutionPlan as TPlan
from repro_torch.api import InferenceSession as TSession
from repro_torch.core import exchange as tx
from repro_torch.models import transformer as ttfm
from repro_torch.models.bridge import params_from_numpy

ARCHS = ("whisper-large-v3", "llama-3.2-vision-11b")
EXTRA = {"whisper-large-v3": ("frames", 13),
         "llama-3.2-vision-11b": ("image_embeds", 11)}
REDUCED = {"dtype": "float32"}
GATE = 0.5
P, L = 2, 2                        # prism_sim: memory padded to P·L
B, N, T0, N_NEW = 2, 8, 8, 6
MOD_TOL, FWD_TOL, STEP_TOL = 1e-5, 2e-3, 1e-4
PLANS = ("local", "prism_sim")


def _jplan(name):
    return JPlan.local() if name == "local" else JPlan.prism_sim(L=L, cr=1.0)


def _tplan(name):
    return TPlan.local() if name == "local" else TPlan.prism_sim(L=L, cr=1.0)


def _np_params(arch):
    """The JAX package's reduced f32 weights (numpy), every vlm gate at
    GATE."""
    js = JSession.from_config(arch, plans=[JPlan.local()], reduced=REDUCED,
                              seed=0)
    params = jax.tree.map(np.asarray, js.params)
    if "cross_layers" in params:
        params["cross_layers"]["gate"] = np.full_like(
            params["cross_layers"]["gate"], GATE)
    return js.cfg, params


_PAIRS = {}


def _pair(arch):
    """(JAX cfg, JAX params, port cfg, port params) over the same f32
    weights, built once an arch."""
    if arch not in _PAIRS:
        from repro_torch.configs import get_config
        jcfg, np_params = _np_params(arch)
        tcfg = get_config(arch).reduced(**REDUCED)
        _PAIRS[arch] = (jcfg, jax.tree.map(jnp.asarray, np_params), tcfg,
                        params_from_numpy(np_params, tcfg, device="cpu"))
    return _PAIRS[arch]


def _tokens(seed, shape, vocab):
    return np.random.RandomState(seed).randint(0, vocab, size=shape
                                               ).astype(np.int32)


def _memory_input(arch, seed=7):
    name, m = EXTRA[arch]
    d = _pair(arch)[0].d_model
    return name, np.random.RandomState(seed).randn(B, m, d).astype(
        np.float32)


def _batches(arch, tokens):
    name, mem = _memory_input(arch)
    return ({"tokens": jnp.asarray(tokens), name: jnp.asarray(mem)},
            {"tokens": torch.from_numpy(tokens), name: torch.from_numpy(mem)})


def _xcfgs(plan):
    """(JAX, port) exchange configs of ``plan``."""
    return (_jplan(plan).to_exchange_config(),
            _tplan(plan).to_exchange_config())


def _diff(a, b):
    return float(np.abs(np.asarray(a, dtype=np.float64)
                        - np.asarray(b, dtype=np.float64)).max())


def _local_decode():
    """JAX ``decode_attention_sharded`` on the memory it holds whole (see
    the module docstring), patched where ``_cross_attend`` looks it up."""
    real = jx.decode_attention_sharded

    def local(q, k, v, cache_len, cfg, **kw):
        return real(q, k, v, cache_len, jx.ExchangeConfig(), **kw)
    return mock.patch.object(jx, "decode_attention_sharded", local)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_jax_packages(arch):
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    assert dataclasses.asdict(tget(arch)) == dataclasses.asdict(jget(arch))
    reduced = tget(arch).reduced(**REDUCED)
    assert dataclasses.asdict(reduced) == dataclasses.asdict(
        jget(arch).reduced(**REDUCED))
    assert reduced.family == ("audio" if arch == ARCHS[0] else "vlm")


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_unstacks_every_stack(arch):
    """Every layer of every stack bit for bit; the vlm's groups in walk
    order; the gate an f32 scalar."""
    jcfg, np_params = _np_params(arch)
    tcfg = _pair(arch)[2]
    tp = params_from_numpy(np_params, tcfg)
    for name, half, depth, _, lead, _ in ttfm.layer_stacks(tcfg):
        assert len(tp[name]) == depth
        leaves = jax.tree_util.tree_leaves_with_path(np_params[name])
        for path, leaf in leaves:
            keys = [k.key for k in path]
            for i in range(depth):
                got = tp[name][i]
                for k in keys:
                    got = got[k]
                want = leaf.reshape((-1,) + leaf.shape[lead:])[i]
                np.testing.assert_array_equal(got.numpy(), want)
    if arch == ARCHS[0]:
        assert [s[0] for s in ttfm.layer_stacks(tcfg)] == ["enc_layers",
                                                          "dec_layers"]
        assert "enc_norm" in tp and "xattn" in tp["dec_layers"][0]
    else:
        gate = tp["cross_layers"][0]["gate"]
        assert gate.dtype == torch.float32 and gate.ndim == 0
        assert float(gate) == GATE
        k = tcfg.cross_attn_every - 1
        assert len(tp["self_layers"]) == k * len(tp["cross_layers"])
        assert [s[4] for s in ttfm.layer_stacks(tcfg)] == [2, 1]


@pytest.mark.parametrize("arch", ARCHS)
def test_memory_kv_matches_jax(arch):
    jcfg, jp, tcfg, tp = _pair(arch)
    layer = "dec_layers" if arch == ARCHS[0] else "cross_layers"
    _, mem = _memory_input(arch)
    want = jtfm._memory_kv(jax.tree.map(lambda a: a[0], jp[layer])["xattn"],
                           jnp.asarray(mem), jcfg)
    got = ttfm._memory_kv(tp[layer][0]["xattn"], torch.from_numpy(mem),
                          tcfg)
    for n in ("k", "v"):
        assert got[n].shape == want[n].shape
        assert _diff(got[n], want[n]) <= MOD_TOL


@pytest.mark.parametrize("plan", PLANS)
def test_encode_audio_matches_jax(plan):
    """The encoder over 13 frames: unpadded under ``local``, padded to 16
    (its pads attended, as the JAX package's are) under ``prism_sim``."""
    arch = ARCHS[0]
    jcfg, jp, tcfg, tp = _pair(arch)
    jb, tb = _batches(arch, _tokens(1, (B, N), jcfg.vocab_size))
    jxc, txc = _xcfgs(plan)
    mem_j, mask_j = jtfm._encode_audio(jp, jb, jcfg, jxc)
    mem_t, mask_t = ttfm._encode_audio(tp, tb, tcfg, txc)
    assert mem_t.shape == mem_j.shape == (B, 13 if plan == "local" else 16,
                                          jcfg.d_model)
    assert _diff(mem_t, mem_j) <= MOD_TOL
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))


@pytest.mark.parametrize("plan", PLANS)
def test_image_memory_matches_jax(plan):
    arch = ARCHS[1]
    jcfg, jp, tcfg, tp = _pair(arch)
    jb, tb = _batches(arch, _tokens(1, (B, N), jcfg.vocab_size))
    jxc, txc = _xcfgs(plan)
    mem_j, mask_j = jtfm._image_memory(jb, jcfg, jxc)
    mem_t, mask_t = ttfm._image_memory(tb, tcfg, txc)
    assert mem_t.shape == mem_j.shape == (B, 11 if plan == "local" else 12,
                                          jcfg.d_model)
    np.testing.assert_array_equal(mem_t.numpy(), np.asarray(mem_j))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))


def _jax_memory_cache(arch, plan, S):
    """JAX ``init_decode_cache`` of [B, S] with ``prefill_memory`` under
    ``plan``."""
    jcfg, jp, _, _ = _pair(arch)
    jb, _ = _batches(arch, _tokens(1, (B, N), jcfg.vocab_size))
    return jtfm.prefill_memory(jp, jb, jcfg, _jplan(plan).to_exchange_config(),
                               jtfm.init_decode_cache(jcfg, B, S))


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_memory_matches_jax(arch, plan):
    """``mem_kv`` stacked over the memory layers and the mask."""
    jcfg, jp, tcfg, tp = _pair(arch)
    _, tb = _batches(arch, _tokens(1, (B, N), jcfg.vocab_size))
    want = _jax_memory_cache(arch, plan, 12)
    got = ttfm.prefill_memory(tp, tb, tcfg, _xcfgs(plan)[1],
                              ttfm.init_decode_cache(tcfg, B, 12,
                                                     device="cpu"))
    for n in ("k", "v"):
        assert got["mem_kv"][n].shape == want["mem_kv"][n].shape
        assert _diff(got["mem_kv"][n], want["mem_kv"][n]) <= MOD_TOL
    np.testing.assert_array_equal(got["mem_mask"].numpy(),
                                  np.asarray(want["mem_mask"]))
    assert not got["mem_mask"].all() or plan == "local"


@pytest.mark.parametrize("n", [N, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attend_matches_jax(arch, n):
    """``_cross_attend`` over the padded (``prism_sim``) memory under its
    mask: N queries through the cross-attention exchange, one token
    through the decode route (``valid`` real memory tokens)."""
    jcfg, jp, tcfg, tp = _pair(arch)
    mem = _jax_memory_cache(arch, "prism_sim", 12)
    mask = mem["mem_mask"]
    if arch == ARCHS[0]:
        lp = jax.tree.map(lambda a: a[0], jp["dec_layers"])
        jl = {"ln1": lp["ln_x"], "xattn": lp["xattn"]}
        tl = {"ln1": tp["dec_layers"][0]["ln_x"],
              "xattn": tp["dec_layers"][0]["xattn"]}
    else:
        jl = jax.tree.map(lambda a: a[0], jp["cross_layers"])
        tl = tp["cross_layers"][0]
    mkv = {k: v[0] for k, v in mem["mem_kv"].items()}
    x = np.random.RandomState(3).randn(B, n, jcfg.d_model).astype(np.float32)
    local = jx.ExchangeConfig()
    want = jtfm._cross_attend(jl, jnp.asarray(x), mkv, mask, jcfg, local)
    got = ttfm._cross_attend(
        tl, torch.from_numpy(x),
        {k: torch.from_numpy(np.asarray(v)) for k, v in mkv.items()},
        torch.from_numpy(np.asarray(mask)), tcfg, tx.ExchangeConfig(),
        decode=n == 1)
    assert got.shape == (B, n, jcfg.d_model)
    assert _diff(got, want) <= MOD_TOL


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_lm_matches_jax(arch, plan):
    jcfg, jp, tcfg, tp = _pair(arch)
    jb, tb = _batches(arch, _tokens(1, (B, N), jcfg.vocab_size))
    jxc, txc = _xcfgs(plan)
    for last_only in (False, True):
        want, _ = jtfm.forward_lm(jp, jb, jcfg, jxc, last_only=last_only)
        got, aux = ttfm.forward_lm(tp, tb, tcfg, txc, last_only=last_only)
        assert got.shape == want.shape and float(aux) == 0.0
        assert _diff(got, want) <= FWD_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch):
    """Single-pass ``prefill`` after ``prefill_memory`` (the padded
    memory): the last logits and the prompt's K/V in the cache."""
    jcfg, jp, tcfg, tp = _pair(arch)
    toks = _tokens(2, (B, T0), jcfg.vocab_size)
    jb, tb = _batches(arch, toks)
    want, jc = jtfm.prefill(jp, jb, _jax_memory_cache(arch, "prism_sim", 12),
                            jcfg, jx.ExchangeConfig())
    tc = ttfm.prefill_memory(tp, tb, tcfg, _xcfgs("prism_sim")[1],
                             ttfm.init_decode_cache(tcfg, B, 12,
                                                    device="cpu"))
    got, tc = ttfm.prefill(tp, tb, tc, tcfg, tx.ExchangeConfig())
    assert _diff(got, want) <= STEP_TOL
    half = "kv" if arch == ARCHS[0] else "self"
    for n in ("k", "v"):
        w = np.asarray(jc[half][n])
        assert _diff(tc[half][n].numpy(), w.reshape(-1, *w.shape[-4:])) \
            <= MOD_TOL


def _port_cache(jcache):
    """A JAX audio/vlm cache as the port lays it out: the vlm's ``self``
    groups flattened into one layer axis."""
    out = {}
    for half, leaves in jcache.items():
        if half == "mem_mask":
            out[half] = torch.from_numpy(np.array(leaves))
            continue
        out[half] = {k: torch.from_numpy(np.array(v).reshape(
            -1, *np.shape(v)[-4:])) for k, v in leaves.items()}
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch):
    """Decode steps over the padded memory, each from the JAX cache before
    it: logits ≤ 1e-4 and the self-attention K/V each step writes."""
    jcfg, jp, tcfg, tp = _pair(arch)
    toks = _tokens(3, (B, 10), jcfg.vocab_size)
    cache = _jax_memory_cache(arch, "prism_sim", 10)
    local = jx.ExchangeConfig()
    half = "kv" if arch == ARCHS[0] else "self"
    for t in range(toks.shape[1]):
        before = _port_cache(cache)
        want, cache = jtfm.decode_step(jp, {"tokens": jnp.asarray(
            toks[:, t:t + 1])}, cache, t, jcfg, local)
        got, after = ttfm.decode_step(tp, {"tokens": torch.from_numpy(
            toks[:, t:t + 1])}, before, t, tcfg, tx.ExchangeConfig())
        assert _diff(got, want) <= STEP_TOL
        wk = np.asarray(cache[half]["k"])
        assert _diff(after[half]["k"][:, :, t].numpy(),
                     wk.reshape(-1, *wk.shape[-4:])[:, :, t]) <= MOD_TOL


_JAX_TOKENS = {}


def _jax_generate(arch, plan, mode):
    """JAX ``session.generate`` of the prompt with the memory input."""
    key = (arch, plan, mode)
    if key not in _JAX_TOKENS:
        jcfg, jp, _, _ = _pair(arch)
        js = JSession(jcfg, jp, plans=[_jplan(plan)])
        name, mem = _memory_input(arch)
        prompt = _tokens(2, (B, T0), jcfg.vocab_size)
        with _local_decode():
            _JAX_TOKENS[key] = np.asarray(js.generate(
                prompt, N_NEW, plan=_jplan(plan), batch_extras={name: mem},
                prefill_mode=mode))
    return _JAX_TOKENS[key]


@pytest.mark.parametrize("mode", ["single_pass", "scan"])
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_is_token_exact(arch, plan, mode):
    jcfg, _, tcfg, tp = _pair(arch)
    ts = TSession(tcfg, tp, plans=[_tplan(plan)], device="cpu")
    name, mem = _memory_input(arch)
    got = ts.generate(_tokens(2, (B, T0), jcfg.vocab_size), N_NEW,
                      plan=_tplan(plan), batch_extras={name: mem},
                      prefill_mode=mode)
    assert got.dtype == torch.int32 and got.shape == (B, N_NEW)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_generate(arch, plan, mode))


def test_a_nonzero_gate_moves_the_logits():
    """With the reference's zero gate ``tanh(0)`` erases the vlm's
    cross-attention (the image tokens move nothing); at GATE they do."""
    arch = ARCHS[1]
    _, _, tcfg, tp = _pair(arch)
    toks = _tokens(1, (B, N), tcfg.vocab_size)
    name, mem = _memory_input(arch)
    local = tx.ExchangeConfig()

    def logits(params, seed):
        m = np.random.RandomState(seed).randn(*mem.shape).astype(np.float32)
        return ttfm.forward_lm(params, {"tokens": torch.from_numpy(toks),
                                        name: torch.from_numpy(m)},
                               tcfg, local)[0]
    shut = dict(tp, cross_layers=[dict(cp, gate=torch.zeros(()))
                                  for cp in tp["cross_layers"]])
    assert torch.equal(logits(shut, 1), logits(shut, 2))
    assert _diff(logits(tp, 1), logits(shut, 1)) > 1e-3
    assert _diff(logits(tp, 1), logits(tp, 2)) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_the_cache_layout(arch):
    from repro.configs.base import ShapeSpec as JShape
    from repro.models import registry as jreg
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import registry
    jcfg, _, tcfg, _ = _pair(arch)
    for kind in ("train", "prefill", "decode"):
        want = jreg.input_specs(jcfg, JShape("s", 48, 3, kind))
        got = registry.input_specs(tcfg, ShapeSpec("s", 48, 3, kind))
        assert {k: (tuple(s.shape), str(s.dtype)) for k, s in
                want.items()} == {
            k: (tuple(s.shape), str(s.dtype).split(".")[1])
            for k, s in got.items()}
    jc = jtfm.init_decode_cache(jcfg, 3, 26)
    tc = ttfm.init_decode_cache(tcfg, 3, 26, device="cpu")
    assert set(tc) == set(jc)
    assert tc["mem_kv"] is None and tc["mem_mask"] is None
    half = "kv" if arch == ARCHS[0] else "self"
    w = jc[half]["k"].shape
    assert tc[half]["k"].shape == (int(np.prod(w[:-4])), *w[-4:])
    xcfg = TPlan.voltage(seq_shards=4).to_exchange_config()
    part = ttfm.init_decode_cache(tcfg, 3, 26, device="cpu", xcfg=xcfg)
    assert part[half]["k"].shape[1:3] == (3, 7)
    with pytest.raises(ValueError, match="prefill_memory"):
        ttfm.decode_step(_pair(arch)[3],
                         {"tokens": torch.zeros(3, 1, dtype=torch.int32)},
                         tc, 0, tcfg, tx.ExchangeConfig())


def test_weight_bytes_count_the_new_stacks():
    """Full width: whisper-large-v3 ~3.1 GB (32 encoder and 32 decoder
    layers, each decoder layer's cross-attention), llama-3.2-vision-11b
    ~19.5 GB (40 layers, 8 of them cross); each equal to the parameters
    the port draws at a reduced size, counted leaf by leaf."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    assert 3.0e9 < registry.weight_bytes(get_config(ARCHS[0])) < 3.2e9
    assert 19.4e9 < registry.weight_bytes(get_config(ARCHS[1])) < 19.7e9
    for arch in ARCHS:
        cfg = get_config(arch).reduced(**REDUCED)
        params = registry.init_params(cfg, seed=0, device="cpu")
        drawn = sum(t.numel() * t.element_size()
                    for t in jax.tree_util.tree_leaves(
                        params, is_leaf=lambda x: isinstance(x, torch.Tensor)))
        assert registry.weight_bytes(cfg) == drawn


@pytest.mark.parametrize("arch", ARCHS)
def test_session_profiles_dispatches_and_refuses_the_slot_pool(arch):
    """On the CPU: the measured profile (its dummy batch carries the
    memory input of ``input_specs``), decide, ``dispatch`` of tokens with
    the memory input against the JAX forward, and the slot pool refused
    naming the families, as in the JAX package."""
    from repro_torch.profiling import SweepSpec
    jcfg, jp, tcfg, tp = _pair(arch)
    ts = TSession(tcfg, tp, plans=[TPlan.local(), _tplan("prism_sim")],
                  device="cpu")
    pm = ts.profile(SweepSpec(batches=(1, 2), crs=(1.0,),
                              bandwidths_mbps=(400.0,), warmup_runs=1),
                    backend="measured", iters=1, warmup=1)
    assert len(pm) == 4
    assert ts.decide(2, 400.0).mode in ("local", "prism")
    jb, tb = _batches(arch, _tokens(4, (B, N), jcfg.vocab_size))
    got = ts.dispatch(tb)
    plan = ts.history[-1].exec_key
    want, _ = jtfm.forward_lm(
        jp, jb, jcfg, _jplan("local" if plan == "local" else
                             "prism_sim").to_exchange_config())
    assert _diff(got, want) <= FWD_TOL
    with pytest.raises(NotImplementedError, match="audio, vlm and vit"):
        ts.init_slot_pool(2, 16)
