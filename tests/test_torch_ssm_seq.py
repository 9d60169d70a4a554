"""The recurrent families across the ranks of a seq group, in the port
against the JAX package: 2 and 4 gloo ranks on the CPU, f32, the JAX
weights carried across by the params bridge (reduced hymba-1.5b and
xlstm-350m).

The JAX package's single-host ``forward_lm`` scans the whole sequence,
so it is the reference for the state hand-off (``core.handoff``): every
mixer on rank p starts from the state rank p − 1 ended with.

* ``forward_lm`` under ``voltage`` against JAX ``local`` (Voltage is
  exact) and under ``prism`` against JAX ``forward_lm`` with
  ``prism_prefill_attention`` patched to the per-partition oracle
  (``_exchange_oracle.prism_oracle``; hymba's layer imports
  ``exchange_attention`` at call time, so the patch reaches it): logits
  ≤ 2e-3 at N 16 (parts of 8 and 4 tokens) and N 8 (parts of 2 tokens
  at P 4, shorter than the conv's W − 1 = 3: the conv tail spans two
  ranks);
* the bytes: each rank p > 0 receives one ``state`` message a mixer,
  the state's size worked out from the shapes (Mamba's h and conv tail,
  mLSTM's C, n and m, sLSTM's c, n, h and m); P − 1 messages a mixer
  across the group; hymba's attention payload as the dense family's;
* decode steps, each from the JAX cache before it (the KV half in the
  rank's block, the recurrent states whole on every rank): logits ≤
  1e-4, no state bytes, hymba's merges as the dense family's;
* greedy ``generate`` under ``voltage`` and ``prism`` (the decode-loop
  prefill: no hand-off) token-exact against JAX ``local``.

Each world size runs every case in one spawn.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks
from _exchange_oracle import prism_oracle
from repro.api import ExecutionPlan as JPlan
from repro.api import InferenceSession as JSession
from repro.core import exchange as jx
from repro.models import transformer as jtfm
from repro_torch.core.seq_group import spawn

ARCHS = ("hymba-1.5b", "xlstm-350m")
REDUCED = {"dtype": "float32"}
B = 2
FORWARDS = ((16, 4), (8, 2))       # (N, L): parts of 8 / 4, and 4 / 2
L_DECODE = 2
PROMPT_B, T0, N_NEW = 2, 8, 6
DEC_B, DEC_S = 2, 12
FWD_TOL, STEP_TOL = 2e-3, 1e-4
PLANS = {"voltage": dict(mode="voltage"), "prism": dict(mode="prism")}


def _tokens(seed, shape, vocab):
    return np.random.RandomState(seed).randint(0, vocab, size=shape
                                               ).astype(np.int32)


def _diff(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


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
            before = jax.tree.map(np.array, cache)
            lg, cache = jtfm.decode_step(
                js.params, {"tokens": jnp.asarray(toks[:, t:t + 1])}, cache,
                t, js.cfg, jx.ExchangeConfig())
            steps.append((before, np.asarray(lg)))
        _STEPS[name] = steps
    return _STEPS[name]


def _forward_tokens(vocab):
    return [_tokens(1 + i, (B, N), vocab) for i, (N, _) in enumerate(FORWARDS)]


_RUNS = {}


def _ranks(jax_side, P):
    if P not in _RUNS:
        vocab = jax_side[ARCHS[0]][0].cfg.vocab_size
        job = dict(
            archs={arch: dict(arch=arch, reduced=REDUCED, params=np_params,
                              caches=[b for b, _ in _decode_steps(js)])
                   for arch, (js, np_params) in jax_side.items()},
            plans=PLANS, forwards=FORWARDS, L=L_DECODE,
            tokens=_forward_tokens(vocab),
            decode_tokens=_tokens(3, (DEC_B, DEC_S), vocab),
            prompt=_tokens(2, (PROMPT_B, T0), vocab), n_new=N_NEW)
        _RUNS[P] = spawn(_torch_ranks.ssm_seq, P, job, timeout=600)
    return _RUNS[P]


def _jax_forward(js, tokens, plan, P, L):
    """JAX ``forward_lm``: ``local`` for ``voltage`` (exact), else the
    PRISM config with the per-partition oracle in place of the sharded
    exchange."""
    if plan == "voltage":
        xcfg = jx.ExchangeConfig()
    else:
        xcfg = jx.ExchangeConfig(jx.ExchangeMode.PRISM, seq_axis="seq",
                                 seq_shards=P, L=L)
    with mock.patch.object(jx, "prism_prefill_attention", prism_oracle):
        logits, _ = jtfm.forward_lm(js.params, {"tokens": jnp.asarray(tokens)},
                                    js.cfg, xcfg)
    return np.asarray(logits)


def _mixer_states(cfg):
    """(mixers a forward, bytes of one hand-off each, f32 states and
    conv tail)."""
    s = cfg.ssm
    if cfg.family == "hybrid":
        di = s.expand * cfg.d_model
        return [B * di * (s.state_size + s.conv_width - 1) * 4] * cfg.n_layers
    H = s.mlstm_heads
    dh = int(cfg.d_model * s.proj_factor) // H
    m = B * H * (dh * dh + dh + 1) * 4
    groups = cfg.n_layers // s.slstm_every
    return ([m] * (s.slstm_every - 1) + [4 * B * cfg.d_model * 4]) * groups


def _payload(cfg, plan, P, N, L):
    """Bytes each rank's attention gathers receive in one forward."""
    if cfg.family != "hybrid":
        return 0
    Np = N // P
    per = (L if plan == "prism" else Np) * B * 4 * (P - 1)
    return cfg.n_layers * per * 2 * cfg.n_kv_heads * cfg.hd


FORWARD_CASES = [(P, arch, plan, i) for P in (2, 4) for arch in ARCHS
                 for plan in PLANS for i in range(len(FORWARDS))]


@pytest.mark.parametrize("P,arch,plan,i", FORWARD_CASES)
def test_forward_lm_matches_the_global_scan(jax_side, P, arch, plan, i):
    js = jax_side[arch][0]
    cfg = js.cfg
    N, L = FORWARDS[i]
    toks = _forward_tokens(cfg.vocab_size)[i]
    want = _jax_forward(js, toks, plan, P, L)
    states = _mixer_states(cfg)
    exchange_calls = cfg.n_layers if cfg.family == "hybrid" else 0
    receives = 0
    runs = _ranks(jax_side, P)
    for p, r in enumerate(runs):
        logits, payload, meta, state, calls = r[arch][f"fwd/{plan}/{i}"]
        assert logits.shape == (B, N, cfg.vocab_size)
        assert _diff(logits, want) <= FWD_TOL
        assert payload == _payload(cfg, plan, P, N, L) and meta == 0
        assert state == (sum(states) if p > 0 else 0)
        receives += calls - exchange_calls - 1          # − the logits gather
    assert receives == (P - 1) * len(states)
    for r in runs[1:]:
        np.testing.assert_array_equal(r[arch][f"fwd/{plan}/{i}"][0],
                                      runs[0][arch][f"fwd/{plan}/{i}"][0])


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_the_handoff_is_needed(jax_side, P, arch):
    """Every rank's part scanned from zeros would differ from the global
    scan: the forward's agreement comes from the hand-off."""
    js = jax_side[arch][0]
    N = FORWARDS[0][0]
    toks = _forward_tokens(js.cfg.vocab_size)[0]
    Np = N // P
    want = _jax_forward(js, toks, "voltage", P, 0)
    alone = np.asarray(jtfm.forward_lm(
        js.params, {"tokens": jnp.asarray(toks[:, -Np:])}, js.cfg,
        jx.ExchangeConfig())[0])
    got = _ranks(jax_side, P)[-1][arch]["fwd/voltage/0"][0]
    assert _diff(got[:, -Np:], want[:, -Np:]) <= FWD_TOL
    assert _diff(alone, want[:, -Np:]) > 1e-2


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_steps_match_jax_local(jax_side, P, arch):
    """Each step from the JAX cache before it, under ``voltage`` and
    ``prism``: logits within 1e-4; no state moves (every rank updates its
    own copy); hymba merges one gather of partials a layer."""
    js = jax_side[arch][0]
    cfg = js.cfg
    hybrid = cfg.family == "hybrid"
    for r in _ranks(jax_side, P):
        for plan in PLANS:
            for (_, want), (logits, merge, state, calls) in zip(
                    _decode_steps(js), r[arch][f"decode/{plan}"]):
                assert _diff(logits, want) <= STEP_TOL
                assert state == 0
                assert calls == (cfg.n_layers if hybrid else 0)
                assert merge == ((P - 1) * DEC_B * cfg.n_heads
                                 * (cfg.hd + 2) * 4 * cfg.n_layers
                                 if hybrid else 0)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_is_token_exact(jax_side, P, arch):
    """``voltage`` and ``prism`` (the decode-loop prefill, as both
    packages take for the family) give JAX ``local``'s tokens on every
    rank, with no state hand-off."""
    js = jax_side[arch][0]
    prompt = _tokens(2, (PROMPT_B, T0), js.cfg.vocab_size)
    want = np.asarray(js.generate(prompt, N_NEW, plan=js.plans["local"]))
    for r in _ranks(jax_side, P):
        for plan in PLANS:
            tokens, state = r[arch][f"gen/{plan}"]
            np.testing.assert_array_equal(tokens, want)
            assert state == 0
