"""The dense LM across the ranks of a seq group, in the port against the
JAX package, reduced f32 llama3.2-1b and internlm2-1.8b on the CPU, the
JAX weights carried across by the params bridge, on 2 and 4 gloo ranks:

* ``voltage`` ``forward_lm``: global ``[B, N, V]`` logits on every rank
  against JAX ``forward_lm`` under ``local`` (Voltage is exact
  attention), ``last_only`` included;
* ``prism`` ``forward_lm`` against JAX ``forward_lm`` with the
  per-partition oracle of ``tests/_exchange_oracle.py`` (causal) in place
  of ``repro.core.exchange.prism_prefill_attention`` — the JAX mesh path
  does not run on the installed JAX — and the bytes gathered against the
  transport accounting;
* ``decode_attention_sharded``: the exact merge against the JAX function
  under ``local``, the PRISM-decode branch against its per-shard oracle;
* 12 ``decode_step``s against the sharded cache (from the port's own
  cache, and each step from the JAX int8 cache) against JAX ``local``;
* greedy ``generate`` token-exact against JAX ``session.generate`` (the
  forced single-pass ``prism`` against JAX ``prism_sim``), the same tokens
  on every rank, sampled tokens the same for the same seed;
* ``dispatch`` runs rank 0's decision on every rank.

Tolerances (PERF.md §6): forward logits ≤ 2e-3, decode-step logits
≤ 1e-4, attention ≤ 1e-5.  Each world size runs every case in one spawn.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks
from _exchange_oracle import prism_decode_oracle, prism_oracle
from repro.api import ExecutionPlan as JPlan
from repro.api import InferenceSession as JSession
from repro.core import exchange as jx
from repro.models import transformer as jtfm
from repro_torch.api import ExecutionPlan as TPlan
from repro_torch.api import InferenceSession as TSession
from repro_torch.core.exchange import ExchangeConfig, ExchangeMode
from repro_torch.core.seq_group import spawn
from repro_torch.models import transformer as ttfm
from repro_torch.transport import exchange_wire_bytes

# label → (arch, reduced config).  The int8 cache rides on a one-layer
# llama: there a step quantizes only K/V projected from the embedding, the
# same f32 values in both packages, so every code is determined.  With a
# second layer its new K/V hang on the first layer's attention, whose last
# bits differ between any two implementations (the port's own
# single-partition step included); a code on a rounding boundary then
# flips and moves the logits by ~3e-4 (ROADMAP queue 3, int8 KV rounding).
# The two-layer decode is held in f32 below, and int8 generate stays
# token-exact.
ARCHS = {"llama": ("llama3.2-1b", {"dtype": "float32"}),
         "internlm2": ("internlm2-1.8b", {"dtype": "float32"}),
         "llama-int8": ("llama3.2-1b", {"dtype": "float32", "n_layers": 1,
                                        "kv_quant": True})}
B, N = 4, 16                    # forward batch; B = 4 makes dispatch
DISPATCH_BW = (1000.0, 400.0, 400.0, 400.0)   # pick prism at 1000 Mbps and
                                              # local at 400 on its own
L_OF = {2: 4, 4: 2}             # segment means: 2 tokens a segment
PROMPT_B, T0, N_NEW = 2, 16, 6
DEC_B, DEC_S, DEC_STEPS = 3, 13, 12   # S = 13 pads to 14 / 16 positions
FWD_TOL, STEP_TOL, ATTN_TOL = 2e-3, 1e-4, 1e-5


def _tokens(seed, shape, vocab):
    return np.random.RandomState(seed).randint(0, vocab, size=shape
                                               ).astype(np.int32)


@pytest.fixture(scope="module")
def jax_side():
    """Per label: the JAX session over the f32 weights, and its weights as
    numpy arrays."""
    out = {}
    for label, (arch, reduced) in ARCHS.items():
        js = JSession.from_config(arch, plans=[JPlan.local()],
                                  reduced=reduced, seed=0)
        out[label] = (js, jax.tree.map(np.asarray, js.params))
    return out


def _vocab(jax_side):
    return jax_side["llama"][0].cfg.vocab_size


_INT8 = []


def _int8_steps(js, steps):
    """Each JAX decode step of the int8 llama: (the cache before it, its
    logits, the cache after it), as numpy arrays; computed once."""
    if not _INT8:
        cache = jtfm.init_decode_cache(js.cfg, DEC_B, DEC_S)
        for t in range(steps.shape[1]):
            before = {k: np.array(v) for k, v in cache["kv"].items()}
            lg, cache = jtfm.decode_step(
                js.params, {"tokens": jnp.asarray(steps[:, t:t + 1])}, cache,
                t, js.cfg, jx.ExchangeConfig())
            _INT8.append((before, np.asarray(lg),
                          {k: np.array(v) for k, v in cache["kv"].items()}))
    return _INT8


_RUNS = {}


def _ranks(jax_side, P):
    if P not in _RUNS:
        vocab = _vocab(jax_side)
        steps = _tokens(3, (DEC_B, DEC_STEPS), vocab)
        archs = {}
        for label, (arch, reduced) in ARCHS.items():
            js, np_params = jax_side[label]
            archs[label] = dict(arch=arch, reduced=reduced, params=np_params)
            if js.cfg.kv_quant:
                archs[label]["caches"] = [before for before, _, _ in
                                          _int8_steps(js, steps)]
        job = dict(archs=archs, L=L_OF[P], bw=DISPATCH_BW,
                   tokens=_tokens(1, (B, N), vocab),
                   prompt=_tokens(2, (PROMPT_B, T0), vocab), n_new=N_NEW,
                   decode_tokens=steps, decode_len=DEC_S,
                   sharded=_sharded_cases(0) + _prism_decode_cases(P))
        _RUNS[P] = spawn(_torch_ranks.lm_seq, P, job, timeout=300)
    return _RUNS[P]


def _diff(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _jax_forward(js, tokens, xcfg, last_only=False):
    with mock.patch.object(jx, "prism_prefill_attention", prism_oracle):
        return np.asarray(jtfm.forward_lm(js.params,
                                          {"tokens": jnp.asarray(tokens)},
                                          js.cfg, xcfg,
                                          last_only=last_only)[0])


LABEL_P = [(label, P) for label in ARCHS for P in (2, 4)]


@pytest.mark.parametrize("label,P", LABEL_P)
def test_voltage_forward_lm_matches_jax_local(jax_side, label, P):
    """Fails on a forward that embeds every rank's slice at positions
    0 … Np−1 or returns only the rank's own slice of the logits."""
    js = jax_side[label][0]
    toks = _tokens(1, (B, N), js.cfg.vocab_size)
    want = _jax_forward(js, toks, jx.ExchangeConfig())
    want_last = _jax_forward(js, toks, jx.ExchangeConfig(), last_only=True)
    for r in _ranks(jax_side, P):
        logits, payload, meta, output, calls = r[label]["fwd/voltage"]
        assert logits.shape == (B, N, js.cfg.vocab_size)
        assert _diff(logits, want) <= FWD_TOL
        assert _diff(r[label]["last/voltage"], want_last) <= FWD_TOL
        cfg = js.cfg
        assert payload == exchange_wire_bytes(
            "identity", n_tokens=N, d_model=2 * cfg.n_kv_heads * cfg.hd,
            bytes_per_el=4, batch=B, P=P, n_layers=cfg.n_layers)
        # no key mask to gather; one gather a layer, one of the logits
        assert meta == 0 and calls == cfg.n_layers + 1
        assert output == (P - 1) * B * (N // P) * cfg.vocab_size * 4


@pytest.mark.parametrize("label,P", LABEL_P)
def test_prism_forward_lm_matches_the_jax_oracle(jax_side, label, P):
    js = jax_side[label][0]
    cfg, L = js.cfg, L_OF[P]
    toks = _tokens(1, (B, N), cfg.vocab_size)
    xcfg = jx.ExchangeConfig(jx.ExchangeMode.PRISM, seq_axis="seq",
                             seq_shards=P, L=L)
    want = _jax_forward(js, toks, xcfg)
    want_last = _jax_forward(js, toks, xcfg, last_only=True)
    runs = _ranks(jax_side, P)
    for r in runs:
        logits, payload, meta, _, _ = r[label]["fwd/prism"]
        assert _diff(logits, want) <= FWD_TOL
        assert _diff(r[label]["last/prism"], want_last) <= FWD_TOL
        assert payload == exchange_wire_bytes(
            "segment_means", n_tokens=N, d_model=2 * cfg.n_kv_heads * cfg.hd,
            bytes_per_el=4, batch=B, P=P, n_layers=cfg.n_layers, L=L)
        assert meta == 0
    for r in runs[1:]:                  # every rank holds the same logits
        np.testing.assert_array_equal(r[label]["fwd/prism"][0],
                                      runs[0][label]["fwd/prism"][0])


def test_prism_and_voltage_differ(jax_side):
    """The compressed forward is not the exact one at these sizes (the
    PRISM check above would hold an exact forward otherwise)."""
    r = _ranks(jax_side, 2)[0]["llama"]
    assert _diff(r["fwd/prism"][0], r["fwd/voltage"][0]) > 10 * FWD_TOL


@pytest.mark.parametrize("P", [2, 4])
def test_decode_steps_match_jax_local(jax_side, P):
    """12 steps from the port's own sharded cache under both plans
    (decode is exact under both), and the blocks hold the JAX cache's
    positions."""
    js = jax_side["llama"][0]
    steps = _tokens(3, (DEC_B, DEC_STEPS), js.cfg.vocab_size)
    cache = jtfm.init_decode_cache(js.cfg, DEC_B, DEC_S)
    want = []
    for t in range(DEC_STEPS):
        lg, cache = jtfm.decode_step(
            js.params, {"tokens": jnp.asarray(steps[:, t:t + 1])}, cache, t,
            js.cfg, jx.ExchangeConfig())
        want.append(np.asarray(lg))
    want = np.concatenate(want, axis=1)
    Sp = -(-DEC_S // P)
    for rank, r in enumerate(_ranks(jax_side, P)):
        for name in ("voltage", "prism"):
            logits, blocks = r["llama"][f"decode/{name}"]
            assert _diff(logits, want) <= STEP_TOL
            assert blocks["k"].shape[2] == Sp
            for leaf in ("k", "v"):
                got = _torch_ranks.cache_block(np.asarray(cache["kv"][leaf]),
                                          rank, P, 2)
                assert _diff(blocks[leaf], got) <= ATTN_TOL


@pytest.mark.parametrize("P", [2, 4])
def test_int8_decode_steps_match_jax_local(jax_side, P):
    """Each step from the JAX int8 cache before it: logits within 1e-4,
    and the step's position written by its owner alone (codes up to one
    rounding step, scales within 1e-5 relative)."""
    js = jax_side["llama-int8"][0]
    steps = _tokens(3, (DEC_B, DEC_STEPS), js.cfg.vocab_size)
    Sp = -(-DEC_S // P)
    runs = _ranks(jax_side, P)
    for t, (before, want, after) in enumerate(_int8_steps(js, steps)):
        for rank, r in enumerate(runs):
            logits, blocks = r["llama-int8"]["decode/int8"][t]
            assert _diff(logits, want) <= STEP_TOL
            for leaf in ("k", "v"):
                codes = _torch_ranks.cache_block(after[leaf], rank, P, 2)
                assert np.abs(blocks[leaf].astype(int)
                              - codes.astype(int)).max() <= 1
                np.testing.assert_allclose(
                    blocks[leaf + "_scale"],
                    _torch_ranks.cache_block(after[leaf + "_scale"], rank,
                                             P, 2),
                    rtol=1e-5, atol=0)
            mine = rank * Sp <= t < (rank + 1) * Sp
            old = _torch_ranks.cache_block(before["k_scale"], rank, P, 2)
            assert (blocks["k_scale"] != old).any() == mine


def _sharded_cases(seed):
    g = np.random.RandomState(seed)
    Bq, S, H, Hk, dh = 3, 12, 4, 2, 16

    def randn(*shape):
        return g.randn(*shape).astype(np.float32)
    q, k, v = randn(Bq, 1, H, dh), randn(Bq, S, Hk, dh), randn(Bq, S, Hk, dh)
    rows = np.array([2, 11, 7], np.int32)
    return [dict(mode="voltage", q=q, k=k, v=v, cache_len=2),
            dict(mode="voltage", q=q, k=k, v=v, cache_len=rows),
            dict(mode="voltage", q=q, k=k, v=v, cache_len=rows,
                 softcap=5.0),
            dict(mode="prism", q=q, k=k, v=v, cache_len=S)]


def _prism_decode_cases(P):
    g = np.random.RandomState(1)
    Bq, S, H, Hk, dh, Lm = 2, 12, 4, 2, 16, 2
    q = g.randn(Bq, 1, H, dh).astype(np.float32)
    k, v = (g.randn(Bq, S, Hk, dh).astype(np.float32) for _ in range(2))
    means = tuple(g.randn(Bq, P, Lm, Hk, dh).astype(np.float32)
                  for _ in range(2))
    return [dict(mode="prism", q=q, k=k, v=v,
                 cache_len=np.array([S, 5], np.int32), means=means,
                 softcap=softcap) for softcap in (None, 5.0)]


@pytest.mark.parametrize("P", [2, 4])
def test_sharded_decode_attention_matches_jax_local(jax_side, P):
    """The exact merge, with the valid prefix inside the first block
    (every other block empty), per-row lengths and a softcap; one gather
    a call of (dh + 2) f32 a head."""
    runs = _ranks(jax_side, P)
    for i, c in enumerate(_sharded_cases(0)):
        want = np.asarray(jx.decode_attention_sharded(
            jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
            jnp.asarray(c["cache_len"]), jx.ExchangeConfig(),
            logit_softcap=c.get("softcap")))
        Bq, _, H, dh = c["q"].shape
        for out, merge_bytes, calls in (r["sharded"][i] for r in runs):
            assert _diff(out, want) <= ATTN_TOL
            assert calls == 1
            assert merge_bytes == (P - 1) * Bq * H * (dh + 2) * 4
        for r in runs[1:]:             # bitwise the same on every rank
            np.testing.assert_array_equal(r["sharded"][i][0],
                                          runs[0]["sharded"][i][0])


@pytest.mark.parametrize("P", [2, 4])
def test_prism_decode_branch_matches_its_per_shard_oracle(jax_side, P):
    """``k_means``/``v_means`` given: each rank attends its block and the
    other blocks' means, with no collective."""
    runs = _ranks(jax_side, P)
    first = len(_sharded_cases(0))
    for i, c in enumerate(_prism_decode_cases(P), start=first):
        for p, r in enumerate(runs):
            out, merge_bytes, calls = r["sharded"][i]
            want = prism_decode_oracle(
                *(jnp.asarray(c[n]) for n in ("q", "k", "v", "cache_len")),
                *(jnp.asarray(m) for m in c["means"]), p, P,
                logit_softcap=c["softcap"])
            assert _diff(out, want) <= ATTN_TOL
            assert calls == 0 and merge_bytes == 0


def _jax_generate(jax_side, label, P, mode):
    js = jax_side[label][0]
    prompt = _tokens(2, (PROMPT_B, T0), js.cfg.vocab_size)
    if mode == "single_pass":         # the compressed prefill: prism_sim
        plan = JPlan.prism_sim(L=L_OF[P], cr=1.0, seq_shards=P)
        return np.asarray(js.generate(prompt, N_NEW, plan=plan,
                                      prefill_mode="single_pass"))
    return np.asarray(js.generate(prompt, N_NEW, plan=js.plans["local"]))


@pytest.mark.parametrize("label,P", LABEL_P)
def test_greedy_generate_is_token_exact(jax_side, label, P):
    runs = _ranks(jax_side, P)
    local = _jax_generate(jax_side, label, P, "auto")
    single = _jax_generate(jax_side, label, P, "single_pass")
    for key, want in (("gen/voltage/auto", local), ("gen/prism/auto", local),
                      ("gen/prism/single_pass", single)):
        for r in runs:
            np.testing.assert_array_equal(r[label][key][0], want)
    # only the forced single-pass prism prefill gathers the prompt K/V for
    # the ranks that own its cache slots: (P − 1) partitions' K and V a
    # layer, booked apart from the exchange's bytes
    cfg = jax_side[label][0].cfg
    moved = ((P - 1) * 2 * PROMPT_B * (T0 // P) * cfg.n_kv_heads * cfg.hd
             * 4 * cfg.n_layers)
    for r in runs:
        assert r[label]["gen/voltage/auto"][1] == 0
        assert r[label]["gen/prism/auto"][1] == 0
        assert r[label]["gen/prism/single_pass"][1] == moved


@pytest.mark.parametrize("P", [2, 4])
def test_sampled_generate_is_the_same_on_every_rank(jax_side, P):
    runs = _ranks(jax_side, P)
    for label in ARCHS:
        a, b, c = runs[0][label]["sampled"]
        np.testing.assert_array_equal(a, b)
        assert a.shape == (PROMPT_B, N_NEW) and not np.array_equal(a, c)
        for r in runs[1:]:
            for got, want in zip(r[label]["sampled"], (a, b, c)):
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("P", [2, 4])
def test_dispatch_takes_rank_zeros_decision(jax_side, P):
    runs = _ranks(jax_side, P)
    for label in ARCHS:
        keys = {r[label]["dispatch"][0] for r in runs}
        assert keys == {TPlan.prism(L=L_OF[P], cr=1.0, seq_shards=P).key}
        assert runs[1][label]["dispatch"][2] == DISPATCH_BW[1]
    # on its own, rank 1's bandwidth picks the other plan
    alone = TSession.from_config(
        "llama3.2-1b", reduced=ARCHS["llama"][1], device="cpu",
        plans=[TPlan.local(), TPlan.prism(L=L_OF[P], cr=1.0, seq_shards=P)])
    alone.profile(backend="simulated")
    assert alone.decide(B, DISPATCH_BW[1]).mode == "local"
    assert alone.decide(B, DISPATCH_BW[0]).mode == "prism"


@pytest.mark.parametrize("mode,N_,L,match", [
    ("voltage", 15, 0, "15 tokens do not split into 2"),
    ("prism", 16, 3, "8 tokens does not split into L=3"),
])
def test_partitioned_forward_refuses_an_indivisible_layout(mode, N_, L,
                                                            match):
    """Refused before any collective, where the JAX package's shard_map
    refuses the layout."""
    cfg = TSession.from_config("llama3.2-1b", reduced=ARCHS["llama"][1],
                               device="cpu").cfg
    xcfg = ExchangeConfig(ExchangeMode(mode), seq_axis="seq", seq_shards=2,
                          L=L)
    with pytest.raises(ValueError, match=match):
        ttfm.forward_lm({}, {"tokens": torch.zeros(1, N_, dtype=torch.int32)},
                        cfg, xcfg)


@pytest.mark.parametrize("plan", [TPlan.voltage(seq_shards=2),
                                  TPlan.prism(L=4, cr=1.0, seq_shards=2)],
                         ids=["voltage", "prism"])
def test_serving_pools_refuse_a_partitioned_plan(plan):
    """The slot pool and the paged pool hold one partition (the JAX
    package's slot pool is not mesh-sharded)."""
    ts = TSession.from_config("llama3.2-1b", reduced=ARCHS["llama"][1],
                              device="cpu", plans=[plan])
    with pytest.raises(NotImplementedError, match="not mesh-sharded"):
        ts.init_slot_pool(2, 16)
    with pytest.raises(NotImplementedError, match="not mesh-sharded"):
        ts.init_page_pool(8, 4)
    local = TSession.from_config("llama3.2-1b", reduced=ARCHS["llama"][1],
                                 device="cpu", plans=[TPlan.local(), plan])
    local.init_slot_pool(2, 16)            # the default plan is local
    with pytest.raises(NotImplementedError, match="not mesh-sharded"):
        local.decode_chunk(None, None, None, None, None, n_steps=1,
                           plan=plan)
