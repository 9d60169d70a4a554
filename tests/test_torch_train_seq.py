"""Training across the ranks of a seq group, in the port against the JAX
package (CPU, reduced f32 llama3.2-1b, the JAX weights carried across by
the bridge, 2 and 4 gloo ranks, one spawn per world size):

* the ranks' loss shares sum to JAX ``loss_fn``'s loss, and their
  gradients, summed by the staged ``all_reduce``, equal
  ``jax.value_and_grad`` of it: under ``voltage`` against JAX ``local``
  (Voltage is exact attention); under ``prism`` against JAX ``prism`` with
  ``tests/_exchange_oracle.py:prism_oracle`` in place of
  ``prism_prefill_attention`` (the JAX mesh path does not run on the
  installed JAX).  The gradient reaches K and V back across the ranks
  through the gather's backward and, under ``prism``, through the
  segment-means and PRISM-attention autograd functions;
* every rank holds the same summed gradient, bit for bit, and the same
  params after two train steps, whose metrics match JAX's
  ``build_train_step``;
* the bytes booked: the forward's gathers (``payload``), the gathers'
  reduce-scattered cotangents and the summed parameter gradients
  (``grad``, f32) equal the shapes;
* ``compressed_cross_pod_mean`` over 2 ranks against the single-process
  JAX formula (the mean of the ranks' compressed payloads, with error
  feedback);
* the launcher on CPU ranks: reduced llama under ``prism``, and gemma2
  (4 ranks: its halo) and hymba (2 ranks: the state hand-off), each
  ending with bit-identical replicas.

The other families' partitioned training is held against JAX in
``tests/test_torch_train_seq_families.py``.

Tolerances (PERF.md §6): gradients ≤ 2e-5 of each leaf's largest value,
the loss ≤ 1e-5 relative, the two steps' metrics ≤ 1e-4.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks
import _train_oracle as orc
from _exchange_oracle import prism_oracle
from repro.core import exchange as jx
from repro.train import grad_compress as jgc
from repro.train.optimizer import OptConfig as JOpt
from repro.train.optimizer import adamw_init as jinit
from repro.train.train_step import build_train_step as jbuild
from repro.train.train_step import loss_fn as jloss
from repro_torch.core.seq_group import spawn
from repro_torch.utils.tree import tree_leaves, tree_unflatten_like

ARCH = "llama3.2-1b"
B, N = 2, 16
L_OF = {2: 4, 4: 2}
MODES = ("voltage", "prism")
GRAD_RTOL, LOSS_RTOL, STEP_RTOL = 2e-5, 1e-5, 1e-4


@pytest.fixture(scope="module")
def side():
    jcfg, cfg = orc.configs(ARCH)
    jp, tp = orc.weights(jcfg, cfg)
    return jcfg, cfg, jp, tp


def _compress_job():
    rng = np.random.RandomState(7)
    trees = [{"w": rng.randn(8, 3).astype(np.float32),
              "v": rng.randn(5).astype(np.float32),
              "odd": rng.randn(6, 2).astype(np.float32)} for _ in range(2)]
    res = [{k: rng.randn(*v.shape).astype(np.float32) * 0.1
            for k, v in t.items()} for t in trees]
    return dict(grads=trees, residuals=res, L=4)


_RUNS = {}


def _ranks(side, P):
    if P not in _RUNS:
        jcfg, cfg, jp, _ = side
        job = dict(arch=ARCH, reduced={"dtype": "float32"},
                   params=jax.tree.map(np.asarray, jp), L=L_OF[P],
                   modes=MODES, batch=orc.batch(cfg, B, N, seed=1),
                   steps=[orc.batch(cfg, B, N, seed=s) for s in (2, 3)])
        if P == 2:
            job["compress"] = _compress_job()
        _RUNS[P] = spawn(_torch_ranks.train_seq, P, job, timeout=300)
    return _RUNS[P]


def _jx(mode, P):
    if mode == "voltage":
        return jx.ExchangeConfig()
    return jx.ExchangeConfig(jx.ExchangeMode.PRISM, seq_axis="seq",
                             seq_shards=P, L=L_OF[P])


def _jax_grads(side, mode, P):
    jcfg, cfg, jp, _ = side
    b = orc.to_jax(orc.batch(cfg, B, N, seed=1))
    with mock.patch.object(jx, "prism_prefill_attention", prism_oracle):
        (loss, _), g = jax.value_and_grad(
            lambda p: jloss(p, b, jcfg, _jx(mode, P)), has_aux=True)(jp)
    return float(loss), orc.flat(g)


CASES = [(mode, P) for mode in MODES for P in (2, 4)]


@pytest.mark.parametrize("mode,P", CASES)
def test_summed_gradients_match_jax(side, mode, P):
    jcfg, cfg, jp, tp = side
    runs = _ranks(side, P)
    want_loss, want = _jax_grads(side, mode, P)
    got_loss = sum(r[mode]["loss"] for r in runs)
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    got = orc.flat(orc.jax_layout(jp, tree_unflatten_like(
        tp, runs[0][mode]["grads"])))
    assert got.keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        assert float(np.abs(got[k] - want[k]).max()) <= GRAD_RTOL * scale, k
    for r in runs[1:]:
        for a, b in zip(r[mode]["grads"], runs[0][mode]["grads"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode,P", CASES)
def test_gradient_bytes_equal_the_shapes(side, mode, P):
    _, cfg, _, tp = side
    Np, L = N // P, L_OF[P]
    kv = 2 * B * (Np if mode == "voltage" else L) * cfg.n_kv_heads * cfg.hd
    n_params = sum(t.numel() for t in tree_leaves(tp))
    for r in _ranks(side, P):
        bk = r[mode]["booked"]
        # forward: one K/V (or means) gather a layer, no mask, no logits
        assert bk["payload"] == cfg.n_layers * (P - 1) * kv * 4
        assert bk["meta"] == 0 and bk["output"] == 0
        # backward: each gather's cotangent reduce-scattered in f32
        assert bk["grad"] == cfg.n_layers * (P - 1) * kv * 4
        assert bk["calls"] == 2 * cfg.n_layers
        # the parameter gradients summed in f32, one bucket
        assert bk["grad_total"] == bk["grad"] + (P - 1) * 4 * n_params
        assert bk["calls_total"] == bk["calls"] + 1


@pytest.mark.parametrize("mode,P", CASES)
def test_replicas_stay_identical_over_two_steps(side, mode, P):
    jcfg, cfg, jp, _ = side
    runs = _ranks(side, P)
    for r in runs[1:]:
        for a, b in zip(r[mode]["params"], runs[0][mode]["params"]):
            np.testing.assert_array_equal(a, b)
    step = jbuild(jcfg, _jx(mode, P), JOpt(lr=1e-3, warmup_steps=1))
    p, o = jp, jinit(jp)
    with mock.patch.object(jx, "prism_prefill_attention", prism_oracle):
        for s, got in zip((2, 3), runs[0][mode]["metrics"]):
            p, o, m = step(p, o, orc.to_jax(orc.batch(cfg, B, N, seed=s)))
            for k in ("loss", "nll", "grad_norm", "lr"):
                np.testing.assert_allclose(got[k], float(m[k]),
                                           rtol=STEP_RTOL, err_msg=k)


def test_compressed_cross_group_mean_matches_the_jax_formula(side):
    c = _compress_job()
    runs = _ranks(side, 2)
    L = c["L"]
    for k in c["grads"][0]:
        gs = [jnp.asarray(t[k]) for t in c["grads"]]
        rs = [jnp.asarray(t[k]) for t in c["residuals"]]
        g = gs[0]
        if g.ndim < 2 or g.shape[0] % L or g.shape[0] <= L:
            want = np.mean([np.asarray(x) for x in gs], axis=0)
            want_res = [np.asarray(r) for r in rs]
        else:
            zs = [jgc.compress_with_feedback(x, r, L) for x, r in zip(gs, rs)]
            want = np.asarray(jgc.decompress(
                sum(z for z, _ in zs) / len(zs), g.shape[0]))
            want_res = [np.asarray(nr) for _, nr in zs]
        for rank, r in enumerate(runs):
            red, res = r["compress"]
            np.testing.assert_allclose(red[k], want, rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(res[k], want_res[rank], rtol=1e-6,
                                       atol=1e-7)


def _launch(*args, timeout=240):
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH="src")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], capture_output=True, text=True,
                          timeout=timeout, env=env,
                          cwd=os.path.dirname(os.path.dirname(
                              os.path.abspath(__file__))))


def test_launcher_trains_prism_on_two_cpu_ranks(tmp_path):
    out = _launch("--device", "cpu", "--mode", "prism", "--ranks", "2",
                  "--steps", "3", "--batch", "2", "--seq", "32",
                  "--ckpt-dir", str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "TRAIN OK"
    assert any(ln.startswith("step    0 loss ") for ln in lines)
    assert "replicas: bit-identical after 3 steps" in lines
    assert any(ln.startswith("done: loss ") and "mode=prism" in ln
               for ln in lines)


@pytest.mark.parametrize("arch,ranks,halo,state", [
    ("gemma2-27b", "4", 1, 0),        # parts of 16 > window 16 / 2: a halo
    ("hymba-1.5b", "2", 0, 2)])       # one Mamba hand-off a layer
def test_launcher_trains_other_families_on_cpu_ranks(tmp_path, arch, ranks,
                                                     halo, state):
    out = _launch("--device", "cpu", "--arch", arch, "--mode", "prism",
                  "--ranks", ranks, "--steps", "2", "--batch", "2",
                  "--seq", "64", "--ckpt-dir", str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "TRAIN OK"
    assert "replicas: bit-identical after 2 steps" in lines
    step0 = next(ln for ln in lines if ln.startswith("step    0 loss "))
    assert f"{halo} halo calls, {state} state calls" in step0


def test_launcher_asks_for_a_card_by_default():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _launch("--steps", "1", timeout=120)
    assert out.returncode != 0 and "--device cpu" in out.stderr
