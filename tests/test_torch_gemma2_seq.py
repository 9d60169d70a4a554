"""gemma2 across the ranks of a seq group, in the port against the JAX
package: the reduced f32 gemma2 (one local/global pair, window 16, int8
KV cache) on 2 and 4 gloo ranks, the JAX weights carried across by the
params bridge.

* PRISM's halo exchange of a windowed layer (``exchange_attention``): at
  P 4 with N 64 and N 32 (Np 16 and 8, n_halo 1 and 2) each rank receives
  the K and V of the ``min(p, n_halo)`` partitions before it in
  ``n_halo`` staged calls and attends exactly under the window (against
  the JAX Voltage oracle); with ``n_halo = P − 1`` (P 2, and P 4 at N 16)
  or without causality the layer takes the Voltage gather.
* ``forward_lm`` under ``voltage`` against JAX ``local``, under ``prism``
  against JAX ``forward_lm`` with the per-partition oracle of
  ``tests/_exchange_oracle.py`` (the windowed layers exact, as the halo
  is), ``prism`` + int8 against the JAX codec oracle (the windowed layer
  through the Voltage gather) and the ``voltage`` ring (the windowed layer
  gathered, the global one on the ring) against JAX ``local``, each with
  its bytes; ``last_only`` included.
* 24 windowed sharded decode steps, each from the JAX int8 cache before
  it, against JAX ``local`` (blocks wholly outside the window included).
* greedy ``generate`` token-exact on every rank against JAX ``local``;
  the forced single-pass ``prism`` prefill (the halo's, on 64 tokens) the
  same on every rank, its cache gather booked as ``cache``, not payload.

Tolerances (PERF.md §6): forward logits ≤ 2e-3, decode-step logits
≤ 1e-4, attention ≤ 1e-5.  Each world size runs every case in one spawn.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks
from _exchange_oracle import codec_oracle, prism_oracle, voltage_oracle
from repro.api import ExecutionPlan as JPlan
from repro.api import InferenceSession as JSession
from repro.core import exchange as jx
from repro.models import transformer as jtfm
from repro.transport import executor as jex
from repro.transport.codecs import CodecSpec, get_codec
from repro_torch.core.seq_group import spawn

ARCH = "gemma2-27b"
REDUCED = {"dtype": "float32"}
B, L = 2, 4                       # forward batch; PRISM means a partition
PROMPT_B, T0, N_NEW = 2, 16, 8    # 24 positions, past the window of 16
DEC_B, DEC_S = 2, 26              # 24 steps: blocks leave the window
DEC_STEPS = 24
FWD_TOL, STEP_TOL, ATTN_TOL = 2e-3, 1e-4, 1e-5
# exchange cases: (label, N, causal) per world size
EXCHANGE = {4: (("halo1", 64, True), ("halo2", 32, True),
                ("fallback", 16, True), ("acausal", 64, False)),
            2: (("fallback", 64, True), ("fallback32", 32, True))}
# forwards: label → (plan fields, tokens of that many positions)
FORWARDS = {4: {"voltage": (dict(mode="voltage"), 64),
                "prism": (dict(mode="prism", L=L), 64),
                "prism32": (dict(mode="prism", L=L), 32),
                "int8": (dict(mode="prism", codec="int8"), 64),
                "ring": (dict(mode="voltage", overlap_chunks=1), 64)},
            2: {"voltage": (dict(mode="voltage"), 64),
                "prism": (dict(mode="prism", L=L), 64),
                "int8": (dict(mode="prism", codec="int8"), 64),
                "ring": (dict(mode="voltage", overlap_chunks=1), 64)}}
WINDOW, SOFTCAP, SCALE = 16, 50.0, 0.3


@pytest.fixture(scope="module")
def jax_side():
    js = JSession.from_config(ARCH, plans=[JPlan.local()], reduced=REDUCED,
                              seed=0)
    return js, jax.tree.map(np.asarray, js.params)


def _tokens(seed, shape, vocab):
    return np.random.RandomState(seed).randint(0, vocab, size=shape
                                               ).astype(np.int32)


def _exchange_case(N, causal, seed):
    g = np.random.RandomState(seed)
    q = g.randn(B, N, 4, 16).astype(np.float32)
    k, v = (g.randn(B, N, 2, 16).astype(np.float32) for _ in range(2))
    return dict(mode="prism", L=L, q=q, k=k, v=v, causal=causal,
                window=WINDOW, softcap=SOFTCAP, scale=SCALE)


_INT8 = []


def _decode_steps(js):
    """Each JAX decode step under ``local``: (the cache before it, its
    logits), numpy; computed once."""
    if not _INT8:
        toks = _tokens(3, (DEC_B, DEC_STEPS), js.cfg.vocab_size)
        cache = jtfm.init_decode_cache(js.cfg, DEC_B, DEC_S)
        for t in range(DEC_STEPS):
            before = {h: {k: np.array(v) for k, v in leaves.items()}
                      for h, leaves in cache.items()}
            lg, cache = jtfm.decode_step(
                js.params, {"tokens": jnp.asarray(toks[:, t:t + 1])}, cache,
                t, js.cfg, jx.ExchangeConfig())
            _INT8.append((before, np.asarray(lg)))
    return _INT8


_RUNS = {}


def _ranks(jax_side, P):
    if P not in _RUNS:
        js, np_params = jax_side
        vocab = js.cfg.vocab_size
        steps = _decode_steps(js)
        job = dict(
            reduced=REDUCED, params=np_params,
            exchange=[_exchange_case(N, causal, i)
                      for i, (_, N, causal) in enumerate(EXCHANGE[P])],
            forwards={k: (kw, N) for k, (kw, N) in FORWARDS[P].items()},
            tokens={N: _tokens(N, (B, N), vocab) for N in (32, 64)},
            caches=[before for before, _ in steps],
            decode_tokens=_tokens(3, (DEC_B, DEC_STEPS), vocab),
            prompt=_tokens(2, (PROMPT_B, T0), vocab), n_new=N_NEW,
            long_prompt=_tokens(64, (B, 64), vocab))
        _RUNS[P] = spawn(_torch_ranks.gemma_seq, P, job, timeout=300)
    return _RUNS[P]


def _diff(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _kv_bytes(n_tokens, cfg_or_hk, dh=None):
    """Bytes of K and V over ``n_tokens`` positions of the forward batch,
    f32."""
    hk, dh = (cfg_or_hk, dh) if dh else (cfg_or_hk.n_kv_heads,
                                         cfg_or_hk.hd)
    return 2 * B * n_tokens * hk * dh * 4


EXCHANGE_CASES = [(P, i) for P in (2, 4) for i in range(len(EXCHANGE[P]))]


@pytest.mark.parametrize("P,i", EXCHANGE_CASES)
def test_windowed_prism_exchange_matches_the_voltage_oracle(jax_side, P, i):
    """The halo is exact under the window, and so is the fallback; the
    halo makes ``n_halo`` staged calls, receives ``min(p, n_halo)``
    partitions of K and V and calls no ``kv_sink``; the fallback gathers
    every partition once and hands the global K/V to ``kv_sink``."""
    label, N, causal = EXCHANGE[P][i]
    c = _exchange_case(N, causal, i)
    cfg = jx.ExchangeConfig(jx.ExchangeMode.PRISM, seq_axis="seq",
                            seq_shards=P, L=L)
    want = np.asarray(voltage_oracle(
        *(jnp.asarray(c[n]) for n in ("q", "k", "v")), cfg, causal=causal,
        window=WINDOW, logit_softcap=SOFTCAP, scale=SCALE))
    Np = N // P
    n_halo = min(-(-WINDOW // Np), P - 1)
    halo = causal and n_halo < P - 1
    assert halo == label.startswith("halo")
    runs = _ranks(jax_side, P)
    for p, r in enumerate(runs):
        out, payload, meta, calls, seen = r["exchange"][i]
        assert _diff(out, want[:, p * Np:(p + 1) * Np]) <= ATTN_TOL
        assert meta == 0
        if halo:
            assert calls == n_halo and seen is None
            assert payload == min(p, n_halo) * _kv_bytes(Np, 2, 16)
        else:
            assert calls == 1 and payload == (P - 1) * _kv_bytes(Np, 2, 16)
            np.testing.assert_array_equal(seen[0], c["k"])


def _jax_forward(js, tokens, xcfg, last_only=False):
    with mock.patch.object(jx, "prism_prefill_attention", prism_oracle), \
            mock.patch.object(jex, "codec_prefill_attention", codec_oracle):
        return np.asarray(jtfm.forward_lm(js.params,
                                          {"tokens": jnp.asarray(tokens)},
                                          js.cfg, xcfg,
                                          last_only=last_only)[0])


def _jax_xcfg(kw, P):
    exact = kw["mode"] == "voltage"
    if exact:
        return jx.ExchangeConfig()           # Voltage and the ring: exact
    return jx.ExchangeConfig(jx.ExchangeMode.PRISM, seq_axis="seq",
                             seq_shards=P, L=kw.get("L", 0),
                             codec=kw.get("codec", ""))


def _payload(cfg, label, kw, N, P, p):
    """What rank p's staged calls receive in one forward: the windowed
    layer's halo (causal, n_halo < P − 1 under ``prism``) or Voltage
    gather, then the global layer's exchange."""
    Np = N // P
    n_halo = min(-(-cfg.window // Np), P - 1)
    full = (P - 1) * _kv_bytes(Np, cfg)
    if kw["mode"] == "prism" and not kw.get("codec") and n_halo < P - 1:
        local = min(p, n_halo) * _kv_bytes(Np, cfg)
    else:
        local = full
    if kw["mode"] == "voltage":
        glob = full
    elif kw.get("codec"):
        wire = get_codec(kw["codec"]).wire_bytes(
            (B, Np, cfg.n_kv_heads, cfg.hd), np.float32, CodecSpec())
        glob = 2 * wire * (P - 1)
    else:
        glob = (P - 1) * 2 * B * kw["L"] * cfg.n_kv_heads * cfg.hd * 4
    return local + glob


FORWARD_CASES = [(P, label) for P in (2, 4) for label in FORWARDS[P]]


@pytest.mark.parametrize("P,label", FORWARD_CASES)
def test_forward_lm_matches_jax(jax_side, P, label):
    js = jax_side[0]
    kw, N = FORWARDS[P][label]
    toks = _tokens(N, (B, N), js.cfg.vocab_size)
    xcfg = _jax_xcfg(kw, P)
    want = _jax_forward(js, toks, xcfg)
    want_last = _jax_forward(js, toks, xcfg, last_only=True)
    runs = _ranks(jax_side, P)
    for p, r in enumerate(runs):
        logits, payload, meta, calls, last = r[f"fwd/{label}"]
        assert logits.shape == (B, N, js.cfg.vocab_size)
        assert _diff(logits, want) <= FWD_TOL
        assert _diff(last, want_last) <= FWD_TOL
        assert payload == _payload(js.cfg, label, kw, N, P, p) and meta == 0
    for r in runs[1:]:                  # every rank holds the same logits
        np.testing.assert_array_equal(r[f"fwd/{label}"][0],
                                      runs[0][f"fwd/{label}"][0])


def test_halo_calls_in_a_forward(jax_side):
    """At P 4, N 64 (n_halo 1) the prism forward makes one halo call for
    the windowed layer, one means gather for the global layer and one
    gather of the logits; at N 32 (n_halo 2) two halo calls."""
    runs = _ranks(jax_side, 4)
    for r in runs:
        assert r["fwd/prism"][3] == 1 + 1 + 1
        assert r["fwd/prism32"][3] == 2 + 1 + 1
        assert r["fwd/voltage"][3] == 1 + 1 + 1


@pytest.mark.parametrize("P", [2, 4])
def test_windowed_sharded_decode_steps_match_jax_local(jax_side, P):
    """Each step from the JAX int8 cache before it, under ``voltage`` and
    ``prism`` (decode is exact under both): logits within 1e-4, one merge
    gather a layer of (dh + 2) f32 a head."""
    js = jax_side[0]
    cfg = js.cfg
    runs = _ranks(jax_side, P)
    for t, (_, want) in enumerate(_decode_steps(js)):
        for r in runs:
            for label in ("voltage", "prism"):
                logits, merge, calls = r[f"decode/{label}"][t]
                assert _diff(logits, want) <= STEP_TOL
                assert calls == cfg.n_layers
                assert merge == ((P - 1) * DEC_B * cfg.n_heads
                                 * (cfg.hd + 2) * 4 * cfg.n_layers)


@pytest.mark.parametrize("P", [2, 4])
def test_greedy_generate_is_token_exact(jax_side, P):
    """``voltage`` (single-pass prefill, the Voltage gather feeding the
    cache, no cache gather) and ``prism`` (the decode-loop prefill) give
    JAX ``local``'s tokens on every rank."""
    js = jax_side[0]
    prompt = _tokens(2, (PROMPT_B, T0), js.cfg.vocab_size)
    want = np.asarray(js.generate(prompt, N_NEW, plan=js.plans["local"]))
    for r in _ranks(jax_side, P):
        for label in ("voltage", "prism"):
            tokens, cache_bytes = r[f"gen/{label}"]
            np.testing.assert_array_equal(tokens, want)
            assert cache_bytes == 0


@pytest.mark.parametrize("P", [2, 4])
def test_single_pass_prism_prefill_books_its_cache_gather_apart(jax_side,
                                                                 P):
    """The compressed prefill has no JAX reference (``prism_sim`` raises on
    windowed layers): its tokens agree across ranks and the exchange's
    bytes are the forward's.  The global layer's means, and at P 4 the
    windowed layer's halo, hand the cache no K/V, so those layers gather
    the prompt's K/V for the cache blocks, booked as ``cache``; at P 2 the
    windowed layer's Voltage gather fills its cache."""
    cfg = jax_side[0].cfg
    runs = _ranks(jax_side, P)
    kw = FORWARDS[P]["prism"][0]
    gathering = cfg.n_layers if P == 4 else cfg.n_layers // 2
    for p, r in enumerate(runs):
        tokens, cache_bytes, payload = r["gen/prism/single_pass"]
        np.testing.assert_array_equal(tokens,
                                      runs[0]["gen/prism/single_pass"][0])
        assert tokens.shape == (B, N_NEW)
        assert payload == _payload(cfg, "prism", kw, 64, P, p)
        full = (P - 1) * _kv_bytes(64 // P, cfg)
        assert cache_bytes == full * gathering
