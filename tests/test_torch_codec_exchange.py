"""The port's codec exchange and ring executor across 2 and 4 gloo ranks on
the CPU, against the JAX package, in f32.

* ``codec_prefill_attention`` (a ``prism`` plan with ``int8``, ``int4``
  or ``topk``), causal and not, with and without a key mask, against the
  per-partition composition of the JAX codec's encode and decode and
  ``reference_attention`` (``tests/_exchange_oracle.py:codec_oracle``),
  ≤ 1e-5; the payload bytes each rank received equal the codec's
  ``wire_bytes`` for K and V times P − 1, in one staged call (the mask in
  a second);
* ``ring_prefill_attention`` (a ``voltage`` plan with ``overlap_chunks``
  1 and 2) against the JAX Voltage oracle and against the JAX
  ``_partial_block`` / ``_merge`` composed in ring order, ≤ 1e-5; the
  global K/V it hands ``kv_sink`` is the input's, bit for bit;
* a reduced f32 ViT under ``prism`` + int8 and under the ring, logits
  ≤ 1e-4 against JAX ``forward_vit`` (the codec exchange replaced by the
  oracle; the ring against JAX ``local``);
* a reduced f32 llama: ``forward_lm`` under the ring ≤ 2e-3 against JAX
  ``local`` and under ``prism`` + int8 against JAX with the oracle; greedy
  ``generate`` under the ring token-exact against JAX on every rank.

Each world size runs its cases in one spawn per kind (join timeout 120 s
for the exchanges, 300 s for the models).
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks
from _exchange_oracle import codec_oracle, ring_oracle, voltage_oracle
from repro.api import ExecutionPlan as JPlan
from repro.api import InferenceSession as JSession
from repro.core.exchange import ExchangeConfig as JConfig
from repro.core.exchange import ExchangeMode as JMode
from repro.transport import executor as jex
from repro_torch.core.seq_group import spawn
from repro_torch.transport import CodecSpec, get_codec

B, N, H, DH = 2, 24, 4, 16
TOL = 1e-5
CODECS = (("int8", 0), ("int4", 8), ("topk", 4))
# codec cases: (codec, param, causal, masked, Hk, softcap)
CODEC_CASES = [(c, prm, causal, masked, 2 if causal else 4,
                30.0 if masked and causal else None)
               for c, prm in CODECS for causal in (False, True)
               for masked in (False, True)]
# ring cases: (overlap_chunks, causal, masked, Hk, softcap)
RING_CASES = [(1, False, True, 4, None), (1, True, False, 2, 30.0),
              (2, True, True, 1, None), (2, False, False, 2, None)]


def _mask(r):
    m = r.rand(B, N) > 0.3
    m[0, :3] = False
    m[1, 18:] = False                 # padding at the tail
    return m


def _qkv(r, hk):
    return dict(q=r.randn(B, N, H, DH).astype(np.float32),
                k=r.randn(B, N, hk, DH).astype(np.float32),
                v=r.randn(B, N, hk, DH).astype(np.float32))


def _cases(P):
    r = np.random.RandomState(10 + P)
    out = []
    for codec, prm, causal, masked, hk, cap in CODEC_CASES:
        c = dict(mode="prism", codec=codec, codec_param=prm, causal=causal,
                 softcap=cap, **_qkv(r, hk))
        if masked:
            c["kv_mask"] = _mask(r)
        out.append(c)
    for chunks, causal, masked, hk, cap in RING_CASES:
        c = dict(mode="voltage", overlap_chunks=chunks, causal=causal,
                 softcap=cap, **_qkv(r, hk))
        if masked:
            c["kv_mask"] = _mask(r)
        out.append(c)
    return out


_RUNS = {}


def _run(P):
    if P not in _RUNS:
        cases = _cases(P)
        _RUNS[P] = cases, spawn(_torch_ranks.exchange_cases, P, cases,
                                timeout=120)
    return _RUNS[P]


def _got(per_rank, i):
    return np.concatenate([r[i][0] for r in per_rank], axis=1)


def _j(c, name):
    return None if c.get(name) is None else jnp.asarray(c[name])


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("i", range(len(CODEC_CASES)))
def test_codec_exchange_matches_the_jax_codec_oracle(P, i):
    cases, per_rank = _run(P)
    c = cases[i]
    cfg = JConfig(JMode.PRISM, seq_axis="seq", seq_shards=P,
                  codec=c["codec"], codec_param=c["codec_param"])
    want = codec_oracle(_j(c, "q"), _j(c, "k"), _j(c, "v"), cfg,
                        causal=c["causal"], logit_softcap=c["softcap"],
                        kv_mask=_j(c, "kv_mask"))
    np.testing.assert_allclose(_got(per_rank, i), np.asarray(want),
                               atol=TOL, rtol=TOL)
    # one staged call for K and V, the codec's bytes; the mask in another
    codec = get_codec(c["codec"])
    part = (B, N // P) + c["k"].shape[2:]
    wire = codec.wire_bytes(part, np.float32,
                            CodecSpec(param=c["codec_param"]))
    masked = "kv_mask" in c
    for _, payload, meta, calls, sink in (r[i] for r in per_rank):
        assert payload == 2 * wire * (P - 1)
        assert meta == (B * (N // P) * (P - 1) if masked else 0)
        assert calls == 1 + masked and sink is None


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("i", range(len(RING_CASES)))
def test_ring_matches_the_jax_voltage_and_ring_oracles(P, i):
    cases, per_rank = _run(P)
    j = len(CODEC_CASES) + i
    c = cases[j]
    q, k, v, m = (_j(c, n) for n in ("q", "k", "v", "kv_mask"))
    got = _got(per_rank, j)
    cfg = JConfig(JMode.VOLTAGE, seq_axis="seq", seq_shards=P)
    want = voltage_oracle(q, k, v, cfg, causal=c["causal"],
                          logit_softcap=c["softcap"], kv_mask=m)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)
    ring = ring_oracle(q, k, v, P, causal=c["causal"],
                       logit_softcap=c["softcap"], kv_mask=m)
    np.testing.assert_allclose(got, np.asarray(ring), atol=TOL, rtol=TOL)
    masked = "kv_mask" in c
    kv_block = 2 * B * (N // P) * c["k"].shape[2] * DH * 4
    for _, payload, meta, calls, sink in (r[j] for r in per_rank):
        assert payload == kv_block * (P - 1)
        assert meta == (B * (N // P) * (P - 1) if masked else 0)
        assert calls == (P - 1) * (1 + masked)
        np.testing.assert_array_equal(sink[0], c["k"])
        np.testing.assert_array_equal(sink[1], c["v"])


def test_jax_ring_oracle_is_the_voltage_oracle():
    """The ring composition of the JAX ``_partial_block`` / ``_merge`` is
    full attention (so the two oracles above agree with each other)."""
    c = _cases(2)[len(CODEC_CASES)]
    q, k, v, m = (_j(c, n) for n in ("q", "k", "v", "kv_mask"))
    a = ring_oracle(q, k, v, 3, kv_mask=m)
    b = voltage_oracle(q, k, v, JConfig(JMode.VOLTAGE, seq_axis="seq",
                                        seq_shards=3), kv_mask=m)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL,
                               rtol=TOL)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

VIT_REDUCED = {"dtype": "float32"}
LM_REDUCED = {"dtype": "float32"}
MODEL_TOL, LM_TOL = 1e-4, 2e-3
LM_B, LM_N, PROMPT_B, T0, N_NEW = 2, 16, 2, 16, 6


@pytest.fixture(scope="module")
def vit_side():
    from repro.configs import get_config as jax_config
    from repro.data.pipeline import SyntheticImageDataset
    from repro.models import registry as jreg
    cfg = jax_config("vit-base-16").reduced(**VIT_REDUCED)
    params = jreg.init_params(cfg, seed=0)
    images, _ = SyntheticImageDataset(batch_size=2, seed=3).sample()
    return cfg, params, images


_MODEL_RUNS = {}


def _vit_run(vit_side):
    if "vit" not in _MODEL_RUNS:
        cfg, params, images = vit_side
        job = dict(arch="vit-base-16", reduced=VIT_REDUCED,
                   params=jax.tree.map(np.asarray, params),
                   batch={"images": images},
                   plans={"int8": dict(mode="prism", codec="int8"),
                          "topk": dict(mode="prism", codec="topk",
                                       codec_param=8),
                          "ring": dict(mode="voltage", overlap_chunks=3)})
        _MODEL_RUNS["vit"] = spawn(_torch_ranks.model_plans, 2, job,
                                   timeout=300)
    return _MODEL_RUNS["vit"]


def _jax_vit(vit_side, codec=None, param=0):
    from repro.models import vit as jvit
    cfg, params, images = vit_side
    xcfg = (JConfig() if codec is None else
            JConfig(JMode.PRISM, seq_axis="seq", seq_shards=2, codec=codec,
                    codec_param=param))
    with mock.patch.object(jex, "codec_prefill_attention", codec_oracle):
        return np.asarray(jvit.forward_vit(params, images, cfg, xcfg))


def _diff(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("label,codec,param", [("int8", "int8", 0),
                                               ("topk", "topk", 8),
                                               ("ring", None, 0)])
def test_vit_across_two_ranks_matches_jax(vit_side, label, codec, param):
    runs = _vit_run(vit_side)
    want = _jax_vit(vit_side, codec, param)
    cfg = vit_side[0]
    Np = 99                            # 197 tokens pad to 198, 2 ranks
    width = (B, Np, cfg.n_kv_heads, cfg.hd)
    for logits, payload, meta, calls in (r[label] for r in runs):
        assert _diff(logits, want) <= MODEL_TOL
        name = codec or "identity"
        spec = CodecSpec(param=param)
        wire = get_codec(name).wire_bytes(width, np.float32, spec)
        assert payload == 2 * wire * cfg.n_layers
        # a K/V call and a mask call a layer, then the logits broadcast
        assert calls == 2 * cfg.n_layers + 1
        assert meta == B * Np * cfg.n_layers
    np.testing.assert_array_equal(runs[0][label][0], runs[1][label][0])


@pytest.fixture(scope="module")
def lm_side():
    js = JSession.from_config("llama3.2-1b", plans=[JPlan.local()],
                              reduced=LM_REDUCED, seed=0)
    return js, jax.tree.map(np.asarray, js.params)


def _lm_run(lm_side, P):
    if P not in _MODEL_RUNS:
        js, np_params = lm_side
        r = np.random.RandomState(5)
        vocab = js.cfg.vocab_size
        job = dict(arch="llama3.2-1b", reduced=LM_REDUCED, params=np_params,
                   batch={"tokens": r.randint(0, vocab, (LM_B, LM_N)
                                              ).astype(np.int32)},
                   prompt=r.randint(0, vocab, (PROMPT_B, T0)
                                    ).astype(np.int32), n_new=N_NEW,
                   plans={"ring": dict(mode="voltage", overlap_chunks=2),
                          "int8": dict(mode="prism", codec="int8")},
                   generate=("ring",))
        _MODEL_RUNS[P] = job, spawn(_torch_ranks.model_plans, P, job,
                                    timeout=300)
    return _MODEL_RUNS[P]


@pytest.mark.parametrize("P", [2, 4])
def test_lm_ring_forward_and_generate_match_jax_local(lm_side, P):
    from repro.models import transformer as jtfm
    js, _ = lm_side
    job, runs = _lm_run(lm_side, P)
    toks = jnp.asarray(job["batch"]["tokens"])
    want = np.asarray(jtfm.forward_lm(js.params, {"tokens": toks}, js.cfg,
                                      JConfig())[0])
    tokens = np.asarray(js.generate(jnp.asarray(job["prompt"]), N_NEW))
    cfg = js.cfg
    kv_block = 2 * LM_B * (LM_N // P) * cfg.n_kv_heads * cfg.hd * 4
    for res in runs:
        logits, payload, meta, _ = res["ring"]
        assert logits.shape == want.shape and _diff(logits, want) <= LM_TOL
        assert payload == kv_block * (P - 1) * cfg.n_layers and meta == 0
        np.testing.assert_array_equal(res["gen/ring"], tokens)


@pytest.mark.parametrize("P", [2, 4])
def test_lm_prism_int8_forward_matches_jax_with_the_codec_oracle(lm_side,
                                                                 P):
    from repro.models import transformer as jtfm
    js, _ = lm_side
    job, runs = _lm_run(lm_side, P)
    xcfg = JConfig(JMode.PRISM, seq_axis="seq", seq_shards=P, codec="int8")
    with mock.patch.object(jex, "codec_prefill_attention", codec_oracle):
        want = np.asarray(jtfm.forward_lm(
            js.params, {"tokens": jnp.asarray(job["batch"]["tokens"])},
            js.cfg, xcfg)[0])
    cfg = js.cfg
    wire = get_codec("int8").wire_bytes(
        (LM_B, LM_N // P, cfg.n_kv_heads, cfg.hd), np.float32, CodecSpec())
    for res in runs:
        logits, payload, meta, calls = res["int8"]
        assert _diff(logits, want) <= LM_TOL
        assert payload == 2 * wire * (P - 1) * cfg.n_layers and meta == 0
    np.testing.assert_array_equal(runs[0]["int8"][0], runs[-1]["int8"][0])
