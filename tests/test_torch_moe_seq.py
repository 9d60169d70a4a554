"""The moe family across the ranks of a seq group, in the port against the
JAX package: 2 and 4 gloo ranks on the CPU, f32, the JAX weights carried
across by the params bridge.

* ``apply_moe`` split over the ranks against the JAX ``apply_moe`` on the
  whole sequence: the same (token, choice) pairs dropped (a low capacity
  factor; the drops are counted from the JAX routing), the 4096-token
  regroup with a group spanning two ranks (N 8192 over 4) and groups
  straddling a rank (N 12288), and the aux loss; one staged routing call
  (``meta``) each.
* The MLA latent exchange against oracles composed in
  ``tests/_exchange_oracle.py`` from the JAX package's per-device bodies:
  ``voltage`` gathers the latent once, ``prism`` takes one segment-means
  call over ``[c_kv ‖ k_pe]`` and gathers the means once; the sharded
  MLA decode (a block with no valid position included) merges one gather
  of packed partials.
* ``forward_lm`` of the reduced deepseek-moe and deepseek-v2 under
  ``voltage`` (against JAX ``local``: it is exact) and ``prism`` (against
  JAX ``forward_lm`` with the per-partition oracles), logits, aux loss
  and every staged call's bytes; ``last_only`` included.
* Decode steps, each from the JAX cache before it, against JAX ``local``;
  greedy ``generate`` token-exact on every rank; the forced single-pass
  ``voltage`` prefill (its routing call, its cache from the gathered
  K/V or latent) against the JAX package's single-pass generate.

Tolerances (PERF.md §6): modules and exchanges ≤ 1e-5, forward logits
≤ 2e-3, decode-step logits ≤ 1e-4, tokens exact.  Each world size runs
every case in one spawn.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks
from _exchange_oracle import (mla_decode_sharded_oracle, mla_oracle,
                              mla_prism_oracle, mla_voltage_oracle,
                              prism_oracle)
from repro.api import ExecutionPlan as JPlan
from repro.api import InferenceSession as JSession
from repro.configs import get_config as jget
from repro.core import exchange as jx
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch.core.seq_group import spawn

ARCHS = ("deepseek-moe-16b", "deepseek-v2-236b")
REDUCED = {"dtype": "float32"}
B, N, L = 2, 32, 4                 # forward batch and length; PRISM means
PROMPT_B, T0, N_NEW = 2, 8, 6
DEC_B, DEC_S = 2, 12
MOD_TOL, FWD_TOL, STEP_TOL = 1e-5, 2e-3, 1e-4
# apply_moe cases: label → (B, N, capacity factor)
MOE = {"drops": (2, 64, 0.5), "regroup": (1, 8192, 0.8),
       "straddle": (1, 12288, 0.8)}
MOE_D = 32
PLANS = {"voltage": dict(mode="voltage"), "prism": dict(mode="prism", L=L)}
# MLA exchange widths: H heads, latent r, rotary dr, nope, v
MLA_H, MLA_R, MLA_DR, MLA_DN, MLA_DV = 4, 24, 8, 16, 12
MLA_SCALE = (MLA_DN + MLA_DR) ** -0.5
MLA_LENS = (12, 7, 2)              # decode cache_len over S 12


def _tokens(seed, shape, vocab):
    return np.random.RandomState(seed).randint(0, vocab, size=shape
                                               ).astype(np.int32)


def _diff(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _moe_cfg(cf):
    return dataclasses.replace(jget("deepseek-moe-16b").reduced().moe,
                               capacity_factor=cf)


def _moe_case(label):
    Bm, Nm, cf = MOE[label]
    cfg = _moe_cfg(cf)
    p = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(1), MOE_D,
                                               cfg, jnp.float32))
    x = np.random.RandomState(2).randn(Bm, Nm, MOE_D).astype(np.float32)
    return dict(params=p, x=x, cfg=dataclasses.asdict(cfg))


def _mla_case(mode, seed):
    g = np.random.RandomState(seed)
    return dict(mode=mode, L=L, scale=MLA_SCALE,
                q=g.randn(B, N, MLA_H, MLA_DN + MLA_DR).astype(np.float32),
                c=g.randn(B, N, MLA_R).astype(np.float32),
                pe=g.randn(B, N, MLA_DR).astype(np.float32),
                w_uk=(g.randn(MLA_R, MLA_H, MLA_DN) * 0.2).astype(np.float32),
                w_uv=(g.randn(MLA_R, MLA_H, MLA_DV) * 0.2).astype(np.float32))


def _mla_decode_case(mode, cache_len, seed):
    g = np.random.RandomState(seed)
    return dict(mode=mode, scale=MLA_SCALE, cache_len=cache_len,
                q_lat=g.randn(DEC_B, 1, MLA_H, MLA_R).astype(np.float32),
                q_pe=g.randn(DEC_B, 1, MLA_H, MLA_DR).astype(np.float32),
                c=g.randn(DEC_B, DEC_S, MLA_R).astype(np.float32),
                pe=g.randn(DEC_B, DEC_S, MLA_DR).astype(np.float32))


MLA_CASES = [(mode, i) for i, mode in enumerate(("voltage", "prism"))]
MLA_DECODE_CASES = [(mode, n) for mode in ("voltage", "prism")
                    for n in MLA_LENS]


@pytest.fixture(scope="module")
def jax_side():
    out = {}
    for arch in ARCHS:
        js = JSession.from_config(arch, plans=[JPlan.local()],
                                  reduced=REDUCED, seed=0)
        out[arch] = (js, jax.tree.map(np.asarray, js.params))
    return out


_STEPS = {}


def _decode_steps(js):
    """Each JAX decode step under ``local``: (the cache before it, its
    logits), numpy; computed once an arch."""
    name = js.cfg.name
    if name not in _STEPS:
        toks = _tokens(3, (DEC_B, DEC_S), js.cfg.vocab_size)
        cache = jtfm.init_decode_cache(js.cfg, DEC_B, DEC_S)
        steps = []
        for t in range(DEC_S):
            before = {h: {k: np.array(v) for k, v in leaves.items()}
                      for h, leaves in cache.items()}
            lg, cache = jtfm.decode_step(
                js.params, {"tokens": jnp.asarray(toks[:, t:t + 1])}, cache,
                t, js.cfg, jx.ExchangeConfig())
            steps.append((before, np.asarray(lg)))
        _STEPS[name] = steps
    return _STEPS[name]


_RUNS = {}


def _ranks(jax_side, P):
    if P not in _RUNS:
        vocab = jax_side[ARCHS[0]][0].cfg.vocab_size
        job = dict(
            moe=[_moe_case(label) for label in sorted(MOE)],
            mla=[_mla_case(mode, i) for mode, i in MLA_CASES],
            mla_decode=[_mla_decode_case(mode, n, i)
                        for i, (mode, n) in enumerate(MLA_DECODE_CASES)],
            archs={arch: dict(arch=arch, reduced=REDUCED, params=np_params,
                              caches=[b for b, _ in _decode_steps(js)])
                   for arch, (js, np_params) in jax_side.items()},
            plans=PLANS, tokens=_tokens(1, (B, N), vocab),
            decode_tokens=_tokens(3, (DEC_B, DEC_S), vocab),
            prompt=_tokens(2, (PROMPT_B, T0), vocab), n_new=N_NEW)
        _RUNS[P] = spawn(_torch_ranks.moe_seq, P, job, timeout=600)
    return _RUNS[P]


def _dropped(p, x, cfg):
    """(token, choice) pairs the JAX routing of the whole sequence drops,
    counted in numpy from its own top-k."""
    Bm, Nm, D = x.shape
    GS = jmoe.GROUP_TOKENS if (Nm > jmoe.GROUP_TOKENS
                               and Nm % jmoe.GROUP_TOKENS == 0) else Nm
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


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("label", sorted(MOE))
def test_apply_moe_routes_the_whole_sequence(jax_side, P, label):
    """Each rank's part of the output and the aux loss equal the JAX
    ``apply_moe`` on the whole sequence, drops included; one routing call
    of ``B · groups · E`` counts and 2·E sums a rank."""
    c = _moe_case(label)
    cfg = _moe_cfg(MOE[label][2])
    Bm, Nm = c["x"].shape[:2]
    yj, aj = jmoe.apply_moe(c["params"], jnp.asarray(c["x"]), cfg)
    assert _dropped(c["params"], c["x"], cfg) > 0
    NG = Nm // jmoe.GROUP_TOKENS if Nm > jmoe.GROUP_TOKENS else 1
    Np = Nm // P
    for p, r in enumerate(_ranks(jax_side, P)):
        y, aux, meta, calls = r["moe"][sorted(MOE).index(label)]
        assert _diff(y, np.asarray(yj)[:, p * Np:(p + 1) * Np]) <= MOD_TOL
        assert abs(aux - float(aj)) <= MOD_TOL * float(aj)
        assert calls == 1
        assert meta == (P - 1) * (Bm * NG * cfg.n_experts
                                  + 2 * cfg.n_experts) * 4


@pytest.mark.parametrize("P", [2, 4])
def test_a_routing_group_spans_ranks(jax_side, P):
    """At N 8192 over 4 ranks a 4096-token group spans two ranks, and the
    ranks of the second half start their positions after the first's
    selections: dropping every rank's part alone would differ."""
    c = _moe_case("regroup")
    cfg = _moe_cfg(MOE["regroup"][2])
    Np = 8192 // P
    alone = np.concatenate([np.asarray(jmoe.apply_moe(
        c["params"], jnp.asarray(c["x"][:, p * Np:(p + 1) * Np]), cfg)[0])
        for p in range(P)], axis=1)
    yj = np.asarray(jmoe.apply_moe(c["params"], jnp.asarray(c["x"]), cfg)[0])
    got = np.concatenate([r["moe"][sorted(MOE).index("regroup")][0]
                          for r in _ranks(jax_side, P)], axis=1)
    assert _diff(got, yj) <= MOD_TOL
    if P == 4:
        assert _diff(alone, yj) > 1e-3


def _mla_args(c):
    return tuple(jnp.asarray(c[n]) for n in ("q", "c", "pe", "w_uk", "w_uv"))


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("mode,i", MLA_CASES)
def test_mla_exchange_matches_the_oracle(jax_side, P, mode, i):
    c = _mla_case(mode, i)
    cfg = jx.ExchangeConfig(jx.ExchangeMode(mode), seq_axis="seq",
                            seq_shards=P, L=L)
    oracle = mla_voltage_oracle if mode == "voltage" else mla_prism_oracle
    want = np.asarray(oracle(*_mla_args(c), cfg, causal=True,
                             scale=MLA_SCALE))
    Np = N // P
    lat = B * (MLA_R + MLA_DR) * 4              # one token's latent, B rows
    for p, r in enumerate(_ranks(jax_side, P)):
        out, payload, meta, calls, seg_calls = r["mla"][i]
        assert out.shape == (B, Np, MLA_H, MLA_DV)
        assert _diff(out, want[:, p * Np:(p + 1) * Np]) <= MOD_TOL
        assert calls == 1 and meta == 0
        if mode == "voltage":
            assert seg_calls == 0 and payload == (P - 1) * Np * lat
        else:
            assert seg_calls == 1 and payload == (P - 1) * L * lat


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("mode,n", MLA_DECODE_CASES)
def test_mla_sharded_decode_matches_the_oracle(jax_side, P, mode, n):
    """Every rank holds the merged output of the JAX per-device body
    (and of the JAX package's local attention over the whole cache); a
    block past ``cache_len`` weighs 0; one merge gather of ``[B, H, r +
    2]`` partials."""
    i = MLA_DECODE_CASES.index((mode, n))
    c = _mla_decode_case(mode, n, i)
    args = tuple(jnp.asarray(c[k]) for k in ("q_lat", "q_pe", "c", "pe"))
    want = np.asarray(mla_decode_sharded_oracle(*args, n, P,
                                                scale=MLA_SCALE))
    local = np.asarray(jx.mla_decode_attention_sharded(
        *args, n, jx.ExchangeConfig(), scale=MLA_SCALE))
    assert _diff(want, local) <= MOD_TOL
    for r in _ranks(jax_side, P):
        out, merge, calls = r["mla_decode"][i]
        assert _diff(out, want) <= MOD_TOL
        assert calls == 1
        assert merge == (P - 1) * DEC_B * MLA_H * (MLA_R + 2) * 4


def _jax_forward(js, tokens, plan, P, last_only=False):
    """JAX ``forward_lm``: ``local`` for ``voltage`` (exact), else the
    PRISM config with the per-partition oracles in place of the sharded
    exchanges."""
    if plan == "voltage":
        xcfg = jx.ExchangeConfig()
    else:
        xcfg = jx.ExchangeConfig(jx.ExchangeMode.PRISM, seq_axis="seq",
                                 seq_shards=P, L=L)
    with mock.patch.object(jx, "prism_prefill_attention", prism_oracle), \
            mock.patch.object(jmla, "exchange_attention_mla", mla_oracle):
        logits, aux = jtfm.forward_lm(js.params,
                                      {"tokens": jnp.asarray(tokens)},
                                      js.cfg, xcfg, last_only=last_only)
    return np.asarray(logits), float(aux)


def _payload(cfg, plan, P):
    """Bytes each rank's attention gathers receive in one forward."""
    Np = N // P
    per = (L if plan == "prism" else Np) * B * 4 * (P - 1)
    if cfg.mla is not None:
        width = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim
    else:
        width = 2 * cfg.n_kv_heads * cfg.hd
    return cfg.n_layers * per * width


FORWARD_CASES = [(P, arch, plan) for P in (2, 4) for arch in ARCHS
                 for plan in PLANS]


@pytest.mark.parametrize("P,arch,plan", FORWARD_CASES)
def test_forward_lm_matches_jax(jax_side, P, arch, plan):
    js = jax_side[arch][0]
    cfg = js.cfg
    toks = _tokens(1, (B, N), cfg.vocab_size)
    want, aux = _jax_forward(js, toks, plan, P)
    want_last, _ = _jax_forward(js, toks, plan, P, last_only=True)
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    for r in _ranks(jax_side, P):
        logits, got_aux, payload, meta, calls, last = r[arch][f"fwd/{plan}"]
        assert logits.shape == (B, N, cfg.vocab_size)
        assert _diff(logits, want) <= FWD_TOL
        assert _diff(last, want_last) <= FWD_TOL
        assert abs(got_aux - aux) <= 1e-4 * aux
        assert payload == _payload(cfg, plan, P)
        # one routing call a MoE layer: B rows × 1 group × E counts + 2·E
        assert meta == n_moe * (P - 1) * (B + 2) * cfg.moe.n_experts * 4
        assert calls == cfg.n_layers + n_moe + 1      # + the logits gather
    runs = _ranks(jax_side, P)
    for r in runs[1:]:
        np.testing.assert_array_equal(r[arch][f"fwd/{plan}"][0],
                                      runs[0][arch][f"fwd/{plan}"][0])


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_steps_match_jax_local(jax_side, P, arch):
    """Each step from the JAX cache before it, under ``voltage`` and
    ``prism`` (decode is exact under both): logits within 1e-4, one merge
    gather a layer and no routing call (a decode step's token is on every
    rank)."""
    js = jax_side[arch][0]
    cfg = js.cfg
    width = (cfg.mla.kv_lora_rank if cfg.mla is not None else cfg.hd) + 2
    for r in _ranks(jax_side, P):
        for plan in PLANS:
            for (_, want), (logits, merge, calls) in zip(
                    _decode_steps(js), r[arch][f"decode/{plan}"]):
                assert _diff(logits, want) <= STEP_TOL
                assert calls == cfg.n_layers
                assert merge == ((P - 1) * DEC_B * cfg.n_heads * width * 4
                                 * cfg.n_layers)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_is_token_exact(jax_side, P, arch):
    """``voltage`` and ``prism`` (the decode-loop prefill, as ``auto``
    keeps for the family) give JAX ``local``'s tokens on every rank; the
    forced single-pass ``voltage`` prefill gives the JAX package's
    single-pass tokens, routes the prompt in one call a MoE layer and
    gathers nothing more for the cache."""
    js = jax_side[arch][0]
    cfg = js.cfg
    prompt = _tokens(2, (PROMPT_B, T0), cfg.vocab_size)
    want = np.asarray(js.generate(prompt, N_NEW, plan=js.plans["local"]))
    single = np.asarray(js.generate(prompt, N_NEW, plan=js.plans["local"],
                                    prefill_mode="single_pass"))
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    for r in _ranks(jax_side, P):
        for plan in PLANS:
            np.testing.assert_array_equal(r[arch][f"gen/{plan}"], want)
        tokens, cache_bytes, meta = r[arch]["gen/voltage/single_pass"]
        np.testing.assert_array_equal(tokens, single)
        assert cache_bytes == 0
        assert meta == n_moe * (P - 1) * (PROMPT_B + 2) * cfg.moe.n_experts * 4
