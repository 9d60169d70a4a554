"""The audio (whisper-large-v3) and vlm (llama-3.2-vision-11b) families
across the ranks of a seq group, in the port against the JAX package: 2
and 4 gloo ranks on the CPU, f32, the JAX weights carried across by the
params bridge, every vlm gate at 0.5.

* ``exchange_cross_attention`` against ``cross_oracle``
  (``tests/_exchange_oracle.py``: the JAX package's per-device body,
  composed partition by partition from its own masked segment means and
  PRISM attention): ``voltage`` gathers the memory block's K/V and its
  mask, ``prism`` takes one segment-means call (K and V) and one
  PRISM-attention call, masked and non-causal, the text partition and the
  memory block of different lengths; a block of padding alone included.
* ``forward_lm`` with 13 frames or 11 image tokens (padded to a multiple
  of P·L, P under ``voltage``) under ``voltage`` and ``prism`` against
  JAX ``forward_lm`` with the per-partition oracles in place of the
  sharded exchanges (the JAX mesh path does not run on the installed
  JAX); every staged call's bytes; ``last_only`` included.
* Decode steps, each from the JAX cache before it (the memory padded as
  the plan pads it), against JAX ``local``: one merge a layer.
* Greedy ``generate`` on every rank against JAX ``session.generate``
  under the same plan with the oracles (and its decode on the memory it
  holds whole, as the JAX VOLTAGE merge computes it); under ``voltage``
  token-exact against JAX ``local`` where padding changes nothing: the
  vlm's masked image tokens, and whisper with 12 frames (no pad).

Tolerances (PERF.md §6): exchanges ≤ 1e-5, forward logits ≤ 2e-3,
decode-step logits ≤ 1e-4, tokens exact.  Each world size runs every
case in one spawn.
"""
import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks
from _exchange_oracle import cross_oracle, prism_oracle, voltage_oracle
from repro.api import ExecutionPlan as JPlan
from repro.api import InferenceSession as JSession
from repro.core import exchange as jx
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch.core.seq_group import spawn
from repro_torch.models.transformer import pad_len

ARCHS = ("whisper-large-v3", "llama-3.2-vision-11b")
EXTRA = {"whisper-large-v3": ("frames", 13),
         "llama-3.2-vision-11b": ("image_embeds", 11)}
REDUCED = {"dtype": "float32"}
GATE = 0.5
B, N, L = 2, 16, 2                 # forward batch and length; PRISM means
PROMPT_B, T0, N_NEW = 2, 8, 6
DEC_S = 10
MOD_TOL, FWD_TOL, STEP_TOL = 1e-5, 2e-3, 1e-4
PLANS = {"voltage": dict(mode="voltage"), "prism": dict(mode="prism", L=L)}
# exchange cases: (mode, query heads, KV heads, real memory length); the
# text is [B, N] and the memory padded to pad_len(M0, P, L), dh 16
CROSS = [(mode, H, Hk, m0) for mode in ("voltage", "prism")
         for H, Hk, m0 in ((4, 4, 13), (4, 2, 11))]
DH = 16


def _xcfg(mode, P):
    return jx.ExchangeConfig(jx.ExchangeMode(mode), seq_axis="seq",
                             seq_shards=P, L=L if mode == "prism" else 0)


def _cross_case(i, P):
    mode, H, Hk, m0 = CROSS[i]
    M = pad_len(m0, P, L)
    g = np.random.RandomState(10 + i)
    return dict(mode=mode, L=L,
                q=g.randn(B, N, H, DH).astype(np.float32),
                k=g.randn(B, M, Hk, DH).astype(np.float32),
                v=g.randn(B, M, Hk, DH).astype(np.float32),
                mask=np.broadcast_to(np.arange(M) < m0, (B, M)).copy())


def _tokens(seed, shape, vocab):
    return np.random.RandomState(seed).randint(0, vocab, size=shape
                                               ).astype(np.int32)


def _diff(a, b):
    return float(np.abs(np.asarray(a, dtype=np.float64)
                        - np.asarray(b, dtype=np.float64)).max())


def _memory(arch, m0=None, seed=7):
    name, m = EXTRA[arch]
    d = 64                                     # the reduced d_model
    return name, np.random.RandomState(seed).randn(
        B, m0 or m, d).astype(np.float32)


@contextlib.contextmanager
def _jax_oracles():
    """The JAX package's partitioned exchanges composed per partition, and
    its decode on the memory and cache it holds whole (the exact VOLTAGE
    merge's answer)."""
    real = jx.decode_attention_sharded

    def local(q, k, v, cache_len, cfg, **kw):
        return real(q, k, v, cache_len, jx.ExchangeConfig(), **kw)
    with mock.patch.object(jx, "prism_prefill_attention", prism_oracle), \
            mock.patch.object(jx, "voltage_prefill_attention",
                              voltage_oracle), \
            mock.patch.object(jtfm, "exchange_cross_attention",
                              cross_oracle), \
            mock.patch.object(jx, "decode_attention_sharded", local), \
            mock.patch.object(jlayers, "decode_attention_sharded", local):
        yield


@pytest.fixture(scope="module")
def jax_side():
    out = {}
    for arch in ARCHS:
        js = JSession.from_config(arch, plans=[JPlan.local()],
                                  reduced=REDUCED, seed=0)
        params = jax.tree.map(np.asarray, js.params)
        if "cross_layers" in params:
            params["cross_layers"]["gate"] = np.full_like(
                params["cross_layers"]["gate"], GATE)
        out[arch] = (js.cfg, params)
    return out


_CACHES = {}


def _decode_caches(jax_side, arch, plan, P):
    """The JAX cache before each decode step under ``local``, from the
    memory ``prefill_memory`` makes under ``plan`` (padded as it pads),
    and each step's logits; numpy, computed once."""
    key = (arch, plan, P)
    if key not in _CACHES:
        cfg, params = jax_side[arch]
        name, mem = _memory(arch)
        toks = _tokens(3, (B, DEC_S), cfg.vocab_size)
        with _jax_oracles():
            cache = jtfm.prefill_memory(
                params, {"tokens": jnp.asarray(toks), name: jnp.asarray(mem)},
                cfg, _xcfg(plan, P), jtfm.init_decode_cache(cfg, B, DEC_S))
        steps = []
        for t in range(DEC_S):
            before = jax.tree.map(np.array, cache)
            lg, cache = jtfm.decode_step(
                params, {"tokens": jnp.asarray(toks[:, t:t + 1])}, cache, t,
                cfg, jx.ExchangeConfig())
            steps.append((before, np.asarray(lg)))
        _CACHES[key] = steps
    return _CACHES[key]


_RUNS = {}


def _ranks(jax_side, P):
    if P not in _RUNS:
        archs = {}
        for arch, (cfg, params) in jax_side.items():
            name, mem = _memory(arch)
            archs[arch] = dict(
                arch=arch, reduced=REDUCED, params=params, memory_name=name,
                memory=mem, gen_memory=_memory(arch, m0=12)[1],
                caches={plan: [b for b, _ in _decode_caches(jax_side, arch,
                                                            plan, P)]
                        for plan in PLANS})
        vocab = jax_side[ARCHS[0]][0].vocab_size
        job = dict(cross=[_cross_case(i, P) for i in range(len(CROSS))],
                   archs=archs, plans=PLANS,
                   tokens=_tokens(1, (B, N), vocab),
                   decode_tokens=_tokens(3, (B, DEC_S), vocab),
                   prompt=_tokens(2, (PROMPT_B, T0), vocab), n_new=N_NEW)
        _RUNS[P] = spawn(_torch_ranks.xattn_seq, P, job, timeout=600)
    return _RUNS[P]


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("i", range(len(CROSS)))
def test_cross_attention_exchange_matches_the_oracle(jax_side, P, i):
    mode, H, Hk, m0 = CROSS[i]
    c = _cross_case(i, P)
    want = np.asarray(cross_oracle(
        *(jnp.asarray(c[n]) for n in ("q", "k", "v", "mask")),
        _xcfg(mode, P)))
    Np, Mp = N // P, c["k"].shape[1] // P
    kv = B * Hk * DH * 4 * 2                     # one token's K and V
    for p, r in enumerate(_ranks(jax_side, P)):
        out, payload, meta, calls, seg, prism = r["cross"][i]
        assert out.shape == (B, Np, H, DH)
        assert _diff(out, want[:, p * Np:(p + 1) * Np]) <= MOD_TOL
        assert calls == 2
        if mode == "voltage":
            assert (seg, prism) == (0, 0)
            assert payload == (P - 1) * Mp * kv and meta == (P - 1) * B * Mp
        else:
            assert (seg, prism) == (1, 1)
            assert payload == (P - 1) * L * kv
            assert meta == (P - 1) * B * L * 4
    if P == 4 and m0 == 11:          # pad_len 16: rank 3 holds padding alone
        assert not c["mask"][:, 12:].any()


def _jax_forward(jax_side, arch, plan, P, last_only=False):
    cfg, params = jax_side[arch]
    name, mem = _memory(arch)
    toks = _tokens(1, (B, N), cfg.vocab_size)
    with _jax_oracles():
        logits, _ = jtfm.forward_lm(
            params, {"tokens": jnp.asarray(toks), name: jnp.asarray(mem)},
            cfg, _xcfg(plan, P), last_only=last_only)
    return np.asarray(logits)


def _forward_bytes(cfg, plan, P):
    """(payload, meta, calls) each rank's staged calls receive in one
    ``forward_lm``, from shapes: each exchange's K/V (in full under
    ``voltage``, L means a partition under ``prism``), the memory's mask
    (``voltage``) or its means' counts (``prism``) a cross layer; whisper's
    encoder exchanges its padded frames unmasked; then the logits."""
    name, m0 = EXTRA[cfg.name]
    Mp = pad_len(m0, P, L if plan == "prism" else 0) // P
    kv = B * cfg.n_kv_heads * cfg.hd * 4 * 2
    per = (lambda n: (P - 1) * (L if plan == "prism" else n) * kv)
    meta = (P - 1) * B * (L * 4 if plan == "prism" else Mp)
    if cfg.family == "audio":
        n_self = n_cross = cfg.n_layers
        payload = cfg.encoder_layers * per(Mp)
        calls = cfg.encoder_layers
    else:
        n_cross = cfg.n_layers // cfg.cross_attn_every
        n_self = cfg.n_layers - n_cross
        payload, calls = 0, 0
    payload += n_self * per(N // P) + n_cross * per(Mp)
    return payload, n_cross * meta, calls + n_self + 2 * n_cross + 1


FORWARD_CASES = [(P, arch, plan) for P in (2, 4) for arch in ARCHS
                 for plan in PLANS]


@pytest.mark.parametrize("P,arch,plan", FORWARD_CASES)
def test_forward_lm_matches_jax(jax_side, P, arch, plan):
    cfg = jax_side[arch][0]
    want = _jax_forward(jax_side, arch, plan, P)
    want_last = _jax_forward(jax_side, arch, plan, P, last_only=True)
    runs = _ranks(jax_side, P)
    for r in runs:
        logits, payload, meta, calls, last = r[arch][f"fwd/{plan}"]
        assert logits.shape == (B, N, cfg.vocab_size)
        assert _diff(logits, want) <= FWD_TOL
        assert _diff(last, want_last) <= FWD_TOL
        assert (payload, meta, calls) == _forward_bytes(cfg, plan, P)
        np.testing.assert_array_equal(logits, runs[0][arch][f"fwd/{plan}"][0])


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_steps_match_jax_local(jax_side, P, arch):
    """Each step from the JAX cache before it (the self-attention cache's
    and the memory's blocks, the global mask): logits within 1e-4, one
    merge gather a self-attention layer and one a cross layer."""
    cfg = jax_side[arch][0]
    n_cross = (cfg.n_layers if cfg.family == "audio"
               else cfg.n_layers // cfg.cross_attn_every)
    n_self = cfg.n_layers if cfg.family == "audio" else cfg.n_layers - n_cross
    for r in _ranks(jax_side, P):
        for plan in PLANS:
            for (_, want), (logits, merge, calls) in zip(
                    _decode_caches(jax_side, arch, plan, P),
                    r[arch][f"decode/{plan}"]):
                assert _diff(logits, want) <= STEP_TOL
                assert calls == n_self + n_cross
                assert merge == ((P - 1) * B * cfg.n_heads * (cfg.hd + 2) * 4
                                 * (n_self + n_cross))


def _jax_generate(jax_side, arch, plan, P, m0=None):
    cfg, params = jax_side[arch]
    name, mem = _memory(arch, m0=m0)
    prompt = _tokens(2, (PROMPT_B, T0), cfg.vocab_size)
    js = JSession(cfg, jax.tree.map(jnp.asarray, params),
                  plans=[JPlan.local()])
    jplan = (JPlan.local() if plan == "local" else
             JPlan.from_exchange_config(_xcfg(plan, P)))
    with _jax_oracles():
        return np.asarray(js.generate(prompt, N_NEW, plan=jplan,
                                      batch_extras={name: mem}))


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_is_token_exact(jax_side, P, arch):
    """Every rank draws the JAX package's tokens under the same plan
    (``voltage``: its single-pass prefill; ``prism``: the decode loop, as
    ``auto`` keeps it); ``voltage`` those of JAX ``local`` where the
    memory's padding changes nothing."""
    runs = _ranks(jax_side, P)
    local12 = _jax_generate(jax_side, arch, "local", P, m0=12)
    for plan in PLANS:
        want = _jax_generate(jax_side, arch, plan, P)
        for r in runs:
            np.testing.assert_array_equal(r[arch][f"gen/{plan}"], want)
    for r in runs:
        np.testing.assert_array_equal(r[arch]["gen/voltage/memory"], local12)
    if arch == ARCHS[1]:                       # masked image tokens
        np.testing.assert_array_equal(runs[0][arch]["gen/voltage"],
                                      _jax_generate(jax_side, arch, "local",
                                                    P))
