"""The port's transport layer against the JAX package's, in one process on
the CPU, f32:

* the ``topk`` codec's payload and reconstruction bit for bit, vectors
  with ties at the k-th magnitude included (``jax.lax.top_k`` puts the
  lower index first; the port selects by a stable sort);
* ``wire_bytes`` equal to the encoded payload's bytes for every codec,
  and to the JAX package's accounting;
* ``measure_decode_bw`` / ``calibrate_codec_bws`` / ``codec_overrides``
  with ``device="cpu"`` (the card is their default);
* ``codec_sim_attention`` and ``codec_sim_prefill_attention`` (the
  ``prism_sim`` plan with a codec) within 1e-5 of the JAX functions;
* the ``measured`` profiling backend over a ``prism_sim`` + int8 plan;
* ``python -m repro_torch.launch.serve --codec ...`` on the CPU: its
  policy line names the decision the JAX package's launcher makes.
"""
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.transport import codec_sim_attention as j_codec_sim
from repro.transport import get_codec as j_codec
from repro.transport import payload_nbytes as j_nbytes
from repro.transport.codecs import CodecSpec as JSpec
from repro_torch.api import ExecutionPlan, InferenceSession
from repro_torch.core.exchange import exchange_attention
from repro_torch.profiling import SweepSpec
from repro_torch.transport import (CodecSpec, calibrate_codec_bws,
                                   codec_overrides, codec_sim_attention,
                                   exchange_cost, get_codec, list_codecs,
                                   measure_decode_bw, payload_nbytes)
from repro_torch.transport.executor import (codec_prefill_attention,
                                            codec_sim_prefill_attention)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5


def _rand(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ties(shape, k, seed=0):
    """Vectors whose magnitudes repeat across the k-th place: values drawn
    from a few levels, signs mixed, so several entries share |x| at the
    cut."""
    r = np.random.RandomState(seed)
    levels = np.array([0.5, 1.0, 2.0], np.float32)
    x = levels[r.randint(0, 3, size=shape)] * r.choice([-1, 1], size=shape)
    return x.astype(np.float32)


TOPK_CASES = [("random", (2, 6, 3, 16), 4), ("random", (3, 5, 64), 8),
              ("ties", (2, 7, 2, 16), 4), ("ties", (4, 9, 32), 8),
              ("ties", (1, 3, 8), 8)]


@pytest.mark.parametrize("kind,shape,k", TOPK_CASES)
def test_topk_matches_jax_bit_for_bit(kind, shape, k):
    x = _ties(shape, k, seed=len(shape)) if kind == "ties" else _rand(shape)
    jc, tc = j_codec("topk"), get_codec("topk")
    jp = jc.encode(jnp.asarray(x), JSpec(param=k))
    tp = tc.encode(torch.from_numpy(x), CodecSpec(param=k))
    assert tp["idx"].dtype == torch.int32
    np.testing.assert_array_equal(tp["idx"].numpy(), np.asarray(jp["idx"]))
    np.testing.assert_array_equal(tp["vals"].numpy(), np.asarray(jp["vals"]))
    jd = jc.decode(jp, JSpec(param=k), shape=x.shape, dtype=jnp.float32)
    td = tc.decode(tp, CodecSpec(param=k), shape=x.shape,
                   dtype=torch.float32)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_topk_ties_keep_the_lower_index():
    x = np.array([[1.0, -2.0, 2.0, 0.5, -2.0]], np.float32)
    p = get_codec("topk").encode(torch.from_numpy(x), CodecSpec(param=2))
    assert p["idx"].tolist() == [[1, 2]]
    with pytest.raises(ValueError, match="0 < k"):
        get_codec("topk").encode(torch.from_numpy(x), CodecSpec(param=6))
    with pytest.raises(ValueError, match="k > 0"):
        get_codec("topk").validate_spec(CodecSpec(param=0))


@pytest.mark.parametrize("name,spec", [
    ("identity", CodecSpec()), ("int8", CodecSpec()),
    ("int8", CodecSpec(param=8)), ("int4", CodecSpec()),
    ("int4", CodecSpec(param=8)), ("topk", CodecSpec(param=4)),
    ("topk", CodecSpec(param=16)), ("segment_means", CodecSpec(L=4))])
def test_wire_bytes_equal_the_payload_and_the_jax_accounting(name, spec):
    assert sorted(list_codecs()) == sorted(["identity", "segment_means",
                                            "int8", "int4", "topk"])
    x = _rand((2, 8, 4, 16))
    codec = get_codec(name)
    payload = codec.encode(torch.from_numpy(x), spec)
    wb = codec.wire_bytes(x.shape, torch.float32, spec)
    assert wb == payload_nbytes(payload)
    jspec = JSpec(L=spec.L, param=spec.param)
    jc = j_codec(name)
    assert wb == jc.wire_bytes(x.shape, jnp.float32, jspec)
    assert wb == j_nbytes(jc.encode(jnp.asarray(x), jspec))
    assert codec.token_wire_bytes(16, 2, spec) == jc.token_wire_bytes(
        16, 2, jspec)
    assert codec.ratio(x.shape, torch.float32, spec) == x.nbytes / wb


def test_topk_wire_bytes_in_bf16():
    codec = get_codec("topk")
    x = torch.from_numpy(_rand((8, 99, 12, 64))).to(torch.bfloat16)
    spec = CodecSpec(param=codec.default_param)
    assert codec.wire_bytes(x.shape, x.dtype, spec) == payload_nbytes(
        codec.encode(x, spec)) == 8 * 99 * 12 * 8 * 6


def _instance_state(name):
    c = get_codec(name)
    return (c.__dict__.get("decode_bw"), c.__dict__.get("decode_bw_measured"))


def test_codec_overrides_restore_the_exact_previous_state():
    before = {n: _instance_state(n) for n in ("int8", "topk")}
    with codec_overrides({"int8": 123.0, "topk": 7.0}):
        assert get_codec("int8").decode_bw == 123.0
        assert get_codec("topk").decode_bw_measured
    assert {n: _instance_state(n) for n in ("int8", "topk")} == before
    assert get_codec("int8").decode_bw == 8e8      # the class constant
    # an installed value is restored as it was, not dropped
    with codec_overrides({"int8": 5.0}):
        with codec_overrides({"int8": 9.0}):
            assert get_codec("int8").decode_bw == 9.0
        assert _instance_state("int8") == (5.0, True)
    assert _instance_state("int8") == before["int8"]


def test_calibration_measures_on_the_cpu_and_feeds_the_cost():
    names = ("int4", "int8", "topk")
    assert all(not get_codec(n).decode_bw_measured for n in names)
    from repro_torch.profiling import WIFI_GLOO
    kw = dict(n_tokens=64, d_model=64, bytes_per_el=4, batch=2, P=2,
              n_layers=2, bandwidth_mbps=400.0, profile=WIFI_GLOO)
    before = exchange_cost("int8", **kw)
    try:
        out = calibrate_codec_bws(shape=(2, 16, 64), iters=2, warmup=1,
                                  device="cpu")
        assert set(out) == set(names)
        for n, bw in out.items():
            c = get_codec(n)
            assert bw > 0 and c.decode_bw == bw and c.decode_bw_measured
        # summarizing and free codecs are never measured
        assert calibrate_codec_bws(names=["segment_means"],
                                   device="cpu") == {}
        assert not get_codec("segment_means").decode_bw_measured
        assert not get_codec("identity").decode_bw_measured
        # cached: a second call returns the measurement without timing
        assert calibrate_codec_bws(shape=(2, 16, 64), device="cpu") == out
        after = exchange_cost("int8", **kw)
        assert after["decode_ms"] == pytest.approx(
            before["decode_ms"] * 8e8 / out["int8"])
        forced = calibrate_codec_bws(names=["topk"], force=True,
                                     shape=(2, 16, 64), iters=1, warmup=0,
                                     device="cpu")
        assert forced["topk"] > 0
    finally:
        for n in names:
            get_codec(n).__dict__.pop("decode_bw", None)
            get_codec(n).__dict__.pop("decode_bw_measured", None)
    assert get_codec("int8").decode_bw == 8e8
    assert measure_decode_bw(get_codec("int4"), shape=(2, 8, 32), iters=1,
                             warmup=0, device="cpu") > 0


def test_measuring_on_the_card_without_one_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        measure_decode_bw(get_codec("int8"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calibrate_codec_bws(names=["int8"], force=True)
    assert not get_codec("int8").decode_bw_measured


SIM_CASES = [(codec, param, causal, cap)
             for codec, param in (("int8", 0), ("int8", 8), ("int4", 0),
                                  ("topk", 4), ("identity", 0))
             for causal, cap in ((False, None), (True, 30.0))]


@pytest.mark.parametrize("codec,param,causal,cap", SIM_CASES)
def test_codec_sim_attention_matches_jax(codec, param, causal, cap):
    q, k, v = (_rand((2, 32, 4, 16), seed=s) for s in (0, 1, 2))
    k, v = k[:, :, :2], v[:, :, :2]                  # GQA: 4 / 2 heads
    want = j_codec_sim(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2,
                       codec, JSpec(param=param), causal=causal,
                       logit_softcap=cap)
    got = codec_sim_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), 2, codec,
                              CodecSpec(param=param), causal=causal,
                              logit_softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("codec,P", [("int8", 2), ("int4", 4), ("topk", 2)])
def test_prism_sim_with_a_codec_routes_to_the_codec_simulation(codec, P):
    """``exchange_attention`` under a ``prism_sim`` plan with a codec runs
    ``codec_sim_prefill_attention``, as the JAX package routes it."""
    from repro.api import ExecutionPlan as JPlan
    from repro.core.exchange import exchange_attention as j_exchange
    q, k, v = (_rand((2, 32, 4, 16), seed=s) for s in (3, 4, 5))
    param = get_codec(codec).default_param
    plan = ExecutionPlan("prism_sim", seq_axis="seq", seq_shards=P,
                         codec=codec, codec_param=param)
    jplan = JPlan("prism_sim", seq_axis="seq", seq_shards=P, codec=codec,
                  codec_param=param)
    got = exchange_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                             plan.to_exchange_config(), causal=True)
    want = j_exchange(*(jnp.asarray(t) for t in (q, k, v)),
                      jplan.to_exchange_config(), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    xcfg = plan.to_exchange_config()
    t = torch.from_numpy(q)
    with pytest.raises(NotImplementedError, match="sliding window"):
        codec_sim_prefill_attention(t, t, t, xcfg, window=4)
    with pytest.raises(NotImplementedError, match="kv_mask"):
        codec_sim_prefill_attention(t, t, t, xcfg,
                                    kv_mask=torch.ones(2, 32, dtype=bool))


def test_a_summarizing_codec_refuses_the_reconstruction_exchange():
    from repro_torch.core.exchange import ExchangeConfig, ExchangeMode
    xcfg = ExchangeConfig(ExchangeMode.PRISM, seq_axis="seq", seq_shards=2,
                          L=2, codec="segment_means")
    t = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="summarizing"):
        codec_prefill_attention(t, t, t, xcfg)


def test_measured_backend_profiles_codec_plans():
    """The measured backend times the codec plan's executable and composes
    it with the transport accounting: the entry lands under the codec's
    key (``tests/test_transport.py`` asserts the same of the JAX
    package)."""
    sess = InferenceSession.from_config(
        "llama3.2-1b", reduced={"vocab_size": 64}, device="cpu",
        plans=[ExecutionPlan.local(),
               ExecutionPlan("prism_sim", seq_axis="seq", seq_shards=2,
                             codec="int8")])
    pm = sess.profile(SweepSpec(batches=(1, 2), bandwidths_mbps=(400.0,)),
                      backend="measured", iters=1, warmup=0)
    e = next((e for k, e in pm.entries()
              if k.mode == "prism" and k.codec == "int8"), None)
    assert e is not None
    assert e.meta["codec"] == "int8" and e.meta["wire_bytes"] > 0
    assert e.staging_ms > 0 and e.comm_ms > 0
    assert "prism+int8" in sess.plans
    from repro_torch.profiling.backends import _dummy_batch
    sess.run("prism+int8", _dummy_batch(sess.cfg, 2, 16, "cpu"))


def _jax_policy(codec, batch, bandwidth):
    """The decision the JAX package's launcher prints for these arguments
    (``--mode prism``): its plans, its simulated sweep with the codec."""
    from repro.api import ExecutionPlan as JPlan
    from repro.api import InferenceSession as JSession
    from repro.profiling import SweepSpec as JSweep
    plans = [JPlan.local(), JPlan.prism_sim(L=4, cr=9.9),
             JPlan("prism_sim", seq_axis="seq", seq_shards=2, codec=codec,
                   codec_param=j_codec(codec).default_param)]
    js = JSession.from_config("llama3.2-1b", reduced={"vocab_size": 512},
                              plans=plans, allow_modes=("prism",),
                              initial_bandwidth_mbps=bandwidth)
    js.profile(JSweep(codecs=(codec,)), backend="simulated")
    return js.decide(batch)


# int8 never wins on the reduced llama in either package (segment means
# at CR 9.9 ship fewer bytes); topk wins at B 8, 400 Mbps
@pytest.mark.parametrize("codec,batch", [("int8", 2), ("topk", 8)])
def test_serve_launcher_with_a_codec_plan(codec, batch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--codec", codec, "--requests", "3", "--batch", str(batch),
         "--tokens", "3", "--prompt-len", "6", "--bandwidth", "400"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.rstrip().endswith("SERVE OK")
    policy = next(ln for ln in out.stdout.splitlines()
                  if ln.startswith("policy:"))
    d = _jax_policy(codec, batch, 400.0)
    want = (f"→ {d.mode}" + (f" CR={d.cr:g}" if d.cr else "")
            + (f" codec={d.codec}" if d.codec else "") + " (")
    assert want in policy, (policy, want)
    if codec == "topk":
        assert "codec=topk" in policy
        assert "'prism+topk': 3" in out.stdout       # served under it
