"""Training on a ``("data", "model")`` mesh of gloo ranks, in the port
against the JAX package (CPU, reduced f32 llama3.2-1b, the JAX weights
carried across by the bridge; one spawn a mesh shape):

* a (2, 2) mesh under ``voltage`` and ``prism`` (each row a seq group over
  ``model``, the batch split over ``data``, the params ZeRO-3 over
  ``data``, the optimizer state ZeRO-1 over both axes), and ``local`` on
  (2, 1) (data-parallel ZeRO): the loss summed over the mesh within 1e-5
  and the gradient, summed over the mesh and gathered whole, within 2e-5
  of each leaf's largest value of ``jax.value_and_grad`` of the JAX
  ``loss_fn`` on the whole batch with the same P-part config
  (``tests/_exchange_oracle.py:prism_oracle`` under ``prism``, as
  ``tests/test_torch_train_seq.py``); one AdamW step with clipping within
  1e-6 of JAX's ``build_train_step`` (the first step's sign line of
  ``tests/_train_oracle.py:check_step``); the ranks of a row hold
  bit-identical shards and the params gathered whole are the same on
  every rank;
* ``prism`` on (2, 2) in 2 microbatches (each microbatch's reduced blocks
  accumulated): the loss and gradient against the same JAX reference;
* deepseek-moe under ``prism`` on (2, 2), in the same spawn (its experts
  sharded over ``model`` too, their row gather's backward summing the
  sequence parts): loss, aux loss and gradient against JAX's;
* the bytes each axis's group receives by kind (``payload``, ``meta``,
  ``grad``, ``param``), and the calls of the parameters' gathers and
  gradient sums, equal a count from the shapes under the JAX package's
  specs (``_train_oracle.zero3_count``: each layer's blocks gathered over
  ``data`` in its forward and its recompute, its gradient reduce-scattered
  as the backward leaves it, the row's sum of the blocks at the end); on
  the dry run's count of the step, a layer adds to a rank's peak only
  its blocks' share (no gathered layer piles up);
* a checkpoint saved from (2, 2) restores bit for bit into (1, 2) (each
  rank its slices) and into one process (the global arrays);
* a ``prism`` forward and a decode step over the (2, 2) mesh, each row its
  slice of the batch, against JAX ``prism_sim`` and the local decode, as
  ``scripts/sanity_e2e_distributed.py`` checks them;
* the launcher: ``--data 2 --ranks 2`` on CPU ranks ends ``TRAIN OK``, a
  run re-meshed to (1, 2) resumes from its checkpoint, and ``--mode
  local`` with a model axis over 1 trains with tensor parallelism
  (``tests/test_torch_tp.py`` holds it to the JAX package).
"""
import os
import subprocess
import sys
import threading
from unittest import mock

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

import _torch_ranks
import _train_oracle as orc
from _exchange_oracle import prism_oracle
from repro.core import exchange as jx
from repro.core.exchange import ExchangeMode as JMode
from repro.models import registry as jreg
from repro.models import transformer as jtfm
from repro.sharding import specs as js
from repro.train.optimizer import OptConfig as JOpt
from repro.train.optimizer import adamw_init as jinit
from repro.train.train_step import build_train_step as jbuild
from repro.train.train_step import loss_fn as jloss
from repro_torch.checkpoint.manager import load_pytree
from repro_torch.core.exchange import ExchangeMode as TMode
from repro_torch.core.seq_group import spawn_mesh
from repro_torch.launch.mesh import make_auto_mesh
from repro_torch.models import registry
from repro_torch.sharding.placement import Placement
from repro_torch.sharding.specs import make_plan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, MOE = "llama3.2-1b", "deepseek-moe-16b"
B, N, L = 4, 16, 4
NAMES = ("data", "model")
CASES = {"voltage": (2, 2), "prism": (2, 2), "local": (2, 1)}
GRAD_RTOL, LOSS_RTOL, STEP_RTOL = 2e-5, 1e-5, 1e-5
PARAM_ATOL, SURE = 1e-6, 100.0
LR = 1e-3
ACCUM = 2
PEAK_SLACK = 0.01           # a layer's saved activations, in its peak


@pytest.fixture(scope="module")
def side():
    jcfg, cfg = orc.configs(ARCH)
    jp, tp = orc.weights(jcfg, cfg)
    return jcfg, cfg, jp, tp


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mesh_ckpt"))


_RUNS = {}


def _job(side, **over):
    jcfg, cfg, jp, _ = side
    return dict(arch=ARCH, reduced={"dtype": "float32"}, L=L,
                params=jax.tree.map(np.asarray, jp),
                batch=orc.batch(cfg, B, N, seed=1), **over)


def _start(side, ckpt_dir):
    """Start the three spawns in the background, once: (2, 2) then the
    re-meshed (1, 2) that restores its checkpoint, and (2, 1); the JAX
    references are computed meanwhile."""
    if _RUNS:
        return
    mj, mc = orc.configs(MOE)
    mp, _ = orc.weights(mj, mc)
    _RUNS["moe"] = (mj, mc, mp)
    first = _job(side, modes=("voltage", "prism"), save=ckpt_dir,
                 save_mode="prism", accum={"prism": ACCUM},
                 forward={"tokens": orc.batch(side[1], B, N,
                                              seed=5)["tokens"]},
                 others={"moe/prism": dict(
                     arch=MOE, mode="prism",
                     params=jax.tree.map(np.asarray, mp),
                     batch=orc.batch(mc, B, N, seed=1))})

    def chain():
        _RUNS[(2, 2)] = spawn_mesh(_torch_ranks.mesh_train, (2, 2), NAMES,
                                   first, timeout=300)
        _RUNS[(1, 2)] = spawn_mesh(
            _torch_ranks.mesh_train, (1, 2), NAMES,
            _job(side, restore=ckpt_dir, save_mode="prism"), timeout=300)

    def local():
        _RUNS[(2, 1)] = spawn_mesh(_torch_ranks.mesh_train, (2, 1), NAMES,
                                   _job(side, modes=("local",)), timeout=300)

    _RUNS["threads"] = [_Runner(chain), _Runner(local)]


class _Runner(threading.Thread):
    """A spawn in the background; ``join`` re-raises what it raised."""

    def __init__(self, fn):
        super().__init__(daemon=True)
        self.fn, self.error = fn, None
        self.start()

    def run(self):
        try:
            self.fn()
        except BaseException as e:          # handed to the test
            self.error = e


def _runs(side, ckpt_dir, shape):
    """The ranks' results of the mesh of ``shape``."""
    _start(side, ckpt_dir)
    for t in _RUNS["threads"]:
        if shape not in _RUNS:
            t.join()
            if t.error is not None:
                raise t.error
    return _RUNS[shape]


def _jx(mode):
    if mode == "prism":
        return jx.ExchangeConfig(JMode.PRISM, seq_axis="seq", seq_shards=2,
                                 L=L)
    return jx.ExchangeConfig()


def _keyed(tree):
    """A JAX tree → {``/``-joined key path: numpy f32}."""
    return {js._path_str(p): np.asarray(leaf, np.float32) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


_JAX = {}


def _jax_ref(side, mode, arch=ARCH):
    """(loss, gradient, the stepped params, the step's metrics) of the JAX
    package on the whole batch (``arch`` MOE: (loss, aux, gradient))."""
    if arch == MOE:
        if arch not in _JAX:
            jcfg, cfg, jp = _RUNS["moe"]
            b = orc.to_jax(orc.batch(cfg, B, N, seed=1))
            with mock.patch.object(jx, "prism_prefill_attention",
                                   prism_oracle):
                (loss, parts), g = jax.jit(jax.value_and_grad(
                    lambda p: jloss(p, b, jcfg, _jx(mode)),
                    has_aux=True))(jp)
            _JAX[arch] = (float(loss), float(parts["aux"]), _keyed(g))
        return _JAX[arch]
    if mode not in _JAX:
        jcfg, cfg, jp, _ = side
        b = orc.to_jax(orc.batch(cfg, B, N, seed=1))
        with mock.patch.object(jx, "prism_prefill_attention", prism_oracle):
            (loss, _), g = jax.jit(jax.value_and_grad(
                lambda p: jloss(p, b, jcfg, _jx(mode)), has_aux=True))(jp)
            new, _, m = jax.jit(jbuild(jcfg, _jx(mode), JOpt(
                lr=LR, warmup_steps=1)))(jp, jinit(jp), b)
        _JAX[mode] = (float(loss), _keyed(g), _keyed(new),
                      {k: float(v) for k, v in m.items()})
    return _JAX[mode]


@pytest.mark.parametrize("mode", list(CASES))
def test_mesh_loss_and_gradients_match_jax(side, ckpt_dir, mode):
    _start(side, ckpt_dir)
    want_loss, want, _, _ = _jax_ref(side, mode)
    runs = _runs(side, ckpt_dir, CASES[mode])
    for r in runs:
        np.testing.assert_allclose(r[mode]["loss"], want_loss, rtol=LOSS_RTOL)
        assert r[mode]["grad_digest"] == runs[0][mode]["grad_digest"]
    got = runs[0][mode]["grads"]
    assert got.keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        assert float(np.abs(got[k] - want[k]).max()) <= GRAD_RTOL * scale, k


@pytest.mark.parametrize("mode", list(CASES))
def test_mesh_adamw_step_matches_jax(side, ckpt_dir, mode):
    runs = _runs(side, ckpt_dir, CASES[mode])
    _, g, want, jm = _jax_ref(side, mode)
    assert jm["grad_norm"] > JOpt().clip_norm          # the clip acts
    tm = runs[0][mode]["metrics"]
    for k in ("loss", "nll", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=STEP_RTOL, atol=1e-7,
                                   err_msg=k)
    got, tg = runs[0][mode]["params"], runs[0][mode]["grads"]
    n_sure = 0
    for k in want:
        noise = max(float(np.abs(tg[k] - g[k]).max()), 1e-12)
        sure = (np.abs(g[k]) > SURE * noise) | ((g[k] == 0) & (tg[k] == 0))
        d = np.abs(got[k] - want[k])
        assert (d[sure] <= PARAM_ATOL).all(), (k, float(d[sure].max()))
        assert (d <= 2 * LR + PARAM_ATOL).all(), (k, float(d.max()))
        n_sure += int(sure.sum())
    assert n_sure > 0.9 * sum(v.size for v in want.values())
    rows = {}
    for r in runs:
        rows.setdefault(r["coords"]["data"], set()).add(
            r[mode]["shard_digest"])
        assert r[mode]["param_digest"] == runs[0][mode]["param_digest"]
    assert all(len(d) == 1 for d in rows.values())


def _want_bytes(side, mode, shape, r, accum=1):
    """Bytes each axis's group receives in a mesh gradient and in a train
    step, from the shapes and the JAX package's specs: (gradient, step),
    and the parameters' calls by kind in the gradient."""
    jcfg, cfg, jp, _ = side
    D, P = shape
    plan = js.make_plan(AbstractMesh(shape, NAMES), jcfg, JMode(mode), L=L,
                        train=True)
    ap = jreg.abstract_params(jcfg)
    spec = {k: tuple(s.spec) for k, s in _keyed_specs(
        js.param_shardings(plan, jcfg, ap)).items()}
    ospec = {k: tuple(s.spec) for k, s in _keyed_specs(
        js.opt_state_shardings(plan, jcfg, ap)).items()}
    numel = {k: int(np.prod(leaf.shape)) for k, leaf in _keyed_leaves(ap)}
    byts, calls = orc.zero3_count(
        r[mode]["whole_shapes"], spec, r[mode]["leads"], D, P,
        tied=cfg.tie_embeddings, seq_row=P > 1, accum=accum)
    model = dict(payload=0, grad=byts["model"]["grad"], meta=0,
                 param=byts["model"]["param"])
    data = dict(payload=0, grad=byts["data"]["grad"], meta=0,
                param=byts["data"]["param"])
    if P > 1:
        rows = N // P if mode == "voltage" else L
        kv = 2 * (B // D) * rows * cfg.n_kv_heads * cfg.hd * 4
        model["payload"] = cfg.n_layers * (P - 1) * kv
        model["grad"] += cfg.n_layers * (P - 1) * kv
        model["meta"] = (P - 1) * 3 * 4
    if D > 1:
        data["meta"] = (D - 1) * 3 * 4
    grads = {"model": dict(model), "data": dict(data)}
    model["meta"] += (P - 1) * 4 if P > 1 else 0          # the norm
    data["meta"] += (D - 1) * 4 if D > 1 else 0
    for k in numel:
        blk = list(r[mode]["opt_shapes"][k])
        s = list(ospec[k]) + [None] * (len(blk) - len(ospec[k]))
        for axis, size, book in (("model", P, model), ("data", D, data)):
            if axis in s and axis not in spec[k] and size > 1:
                book["param"] += (size - 1) * int(np.prod(blk)) * 4
                blk[s.index(axis)] *= size
    return grads, {"model": model, "data": data}, calls


def _keyed_specs(tree):
    return {js._path_str(p): s for p, s in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _keyed_leaves(tree):
    return [(js._path_str(p), leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("mode", list(CASES))
def test_mesh_bytes_equal_the_shapes(side, ckpt_dir, mode):
    shape = CASES[mode]
    for r in _runs(side, ckpt_dir, shape):
        want_g, want_s, _ = _want_bytes(side, mode, shape, r)
        for booked, want in ((r[mode]["booked_grads"], want_g),
                             (r[mode]["booked_step"], want_s)):
            for axis, kinds in want.items():
                got = {k: booked[axis][k] for k in kinds}
                assert got == kinds, (axis, r["coords"])
                assert all(v == 0 for k, v in booked[axis].items()
                           if k not in kinds), (axis, booked[axis])


@pytest.mark.parametrize("mode", list(CASES))
def test_mesh_param_calls_and_gathered_peak(side, ckpt_dir, mode):
    """The parameters' staged calls by axis and kind equal the count from
    the shapes (a ``param`` call over ``data`` a layer in the forward and
    again in the recompute, one a use of the tied table; a ``grad``
    reduce-scatter a gathered layer or use; the end's sums), and the
    rank holds its blocks and one layer: on the dry run's count of the
    same step (``StepCounter``: every storage the step allocates, until
    it is freed), each layer added to the model adds to the rank's peak
    at most 1/D of what it adds to a rank of (1, M) with the same rows,
    which holds the layer whole (``PEAK_SLACK``: the activations a layer
    saves, the same on both).  A step that gathered the whole tree adds
    as much as that rank."""
    shape = CASES[mode]
    for r in _runs(side, ckpt_dir, shape):
        _, _, want = _want_bytes(side, mode, shape, r)
        got = r[mode]["calls"]
        for axis, kinds in want.items():
            for kind, n in kinds.items():
                extra = 0
                if kind == "grad" and axis == "model" and shape[1] > 1:
                    extra = side[1].n_layers      # the exchange's cotangents
                assert got.get(axis, {}).get(kind, 0) == n + extra, (
                    axis, kind, got)
    D, M = shape
    zero3 = orc.added_layer_bytes(ARCH, "train", shape, mode, B=B, N=N, L=L)
    whole = orc.added_layer_bytes(ARCH, "train", (1, M), mode, B=B // D,
                                  N=N, L=L)
    assert 0 < zero3 <= whole / D * (1 + PEAK_SLACK), (zero3, whole)


def test_mesh_moe_prism_matches_jax(side, ckpt_dir):
    """deepseek-moe under ``prism`` on (2, 2): the plan shards its experts
    over ``model`` too, so each layer gathers them over the row, and that
    gather's backward sums the row's sequence parts (a reduce-scatter:
    each rank's block of every rank's gradient).  The loss, the aux loss
    and the gradient of the whole batch as ``jax.value_and_grad``'s
    (within 1e-5 and 2e-5), the same gradient on every rank; the
    parameters' ``param`` bytes and calls on each axis the count from the
    shapes (``zero3_count`` with the sequence over the row)."""
    _start(side, ckpt_dir)
    want_loss, want_aux, want = _jax_ref(side, "prism", MOE)
    runs = _runs(side, ckpt_dir, (2, 2))
    jcfg, cfg, _ = _RUNS["moe"]
    plan = js.make_plan(AbstractMesh((2, 2), NAMES), jcfg, JMode.PRISM, L=L,
                        train=True)
    spec = {k: tuple(s.spec) for k, s in _keyed_specs(js.param_shardings(
        plan, jcfg, jreg.abstract_params(jcfg))).items()}
    assert any("model" in s for s in spec.values())       # the experts
    for r in runs:
        c = r["moe/prism"]
        np.testing.assert_allclose(c["loss"], want_loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(c["aux"], want_aux, rtol=LOSS_RTOL,
                                   atol=1e-12)
        assert c["grad_digest"] == runs[0]["moe/prism"]["grad_digest"]
        byts, calls = orc.zero3_count(c["whole_shapes"], spec, c["leads"],
                                      2, 2, tied=cfg.tie_embeddings,
                                      seq_row=True)
        for axis in NAMES:
            assert c["booked_grads"][axis]["param"] == \
                byts[axis]["param"], axis
            assert c["calls"][axis]["param"] == calls[axis]["param"], axis
    got = runs[0]["moe/prism"]["grads"]
    assert got.keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        assert float(np.abs(got[k] - want[k]).max()) <= GRAD_RTOL * scale, k


def test_mesh_microbatches_match_jax(side, ckpt_dir):
    """``prism`` on (2, 2) in 2 microbatches: each microbatch's blocks
    reduce-scattered as its backward leaves a layer and accumulated; the
    loss and the gradient of the whole batch as ``jax.value_and_grad``'s
    (within 1e-5 and 2e-5); each microbatch gathers and reduce-scatters
    every layer (the bytes and calls of the count with ``accum`` 2), the
    row sums the accumulated blocks once; on the dry run's count, a layer
    adds to the rank's peak its blocks' share, accumulator included (as
    ``test_mesh_param_calls_and_gathered_peak``)."""
    label = f"prism/accum{ACCUM}"
    want_loss, want, _, _ = _jax_ref(side, "prism")
    runs = _runs(side, ckpt_dir, (2, 2))
    for r in runs:
        np.testing.assert_allclose(r[label]["loss"], want_loss,
                                   rtol=LOSS_RTOL)
        want_g, _, calls = _want_bytes(side, "prism", (2, 2), r, ACCUM)
        booked = r[label]["booked_grads"]
        for axis, kinds in want_g.items():
            assert {k: booked[axis][k] for k in kinds} == kinds, axis
        for axis, kinds in calls.items():
            for kind, n in kinds.items():
                extra = side[1].n_layers * ACCUM if (
                    kind, axis) == ("grad", "model") else 0
                assert r[label]["calls"].get(axis, {}).get(kind, 0) == \
                    n + extra, (axis, kind)
    zero3 = orc.added_layer_bytes(ARCH, "train", (2, 2), "prism", B=B, N=N,
                                  L=L, accum=ACCUM)
    whole = orc.added_layer_bytes(ARCH, "train", (1, 2), "prism", B=B // 2,
                                  N=N, L=L, accum=ACCUM)
    assert 0 < zero3 <= whole / 2 * (1 + PEAK_SLACK), (zero3, whole)
    got = runs[0][label]["grads"]
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        assert float(np.abs(got[k] - want[k]).max()) <= GRAD_RTOL * scale, k


def test_checkpoint_moves_between_meshes(side, ckpt_dir):
    """Saved from (2, 2) after one ``prism`` step: restored into (1, 2)
    each rank holds exactly its slices of the global arrays, and in one
    process the global arrays are the (2, 2) mesh's params and moments,
    bit for bit."""
    saved = _runs(side, ckpt_dir, (2, 2))[0]["prism"]
    for r in _runs(side, ckpt_dir, (1, 2)):
        got = r["restored"]
        assert got["step"] == 1
        for k, idx in got["index"].items():
            np.testing.assert_array_equal(got["params"][k],
                                          saved["params"][k][idx])
            np.testing.assert_array_equal(got["m"][k],
                                          saved["m"][k][got["opt_index"][k]])
            np.testing.assert_array_equal(got["whole"][k], saved["params"][k])
    _, cfg, _, _ = side
    mesh = make_auto_mesh((1, 1), NAMES)
    place = Placement(make_plan(mesh, cfg, TMode.PRISM, L=L, train=True),
                      cfg, registry.abstract_params(cfg),
                      coords={"data": 0, "model": 0})
    template, _ = place.state_template()
    params, opt = load_pytree(template, ckpt_dir, device="cpu")
    assert int(opt.step) == 1
    for k in place.keys:
        np.testing.assert_array_equal(params[k].numpy(), saved["params"][k])
        np.testing.assert_array_equal(opt.m[k].numpy(), saved["m"][k])
        np.testing.assert_array_equal(opt.v[k].numpy(), saved["v"][k])
    tree = place.unstack(params)                  # the port's own layout
    assert set(tree) == set(side[3])


def test_prism_forward_and_decode_over_the_mesh(side, ckpt_dir):
    jcfg, cfg, jp, _ = side
    tokens = orc.batch(cfg, B, N, seed=5)["tokens"]
    xsim = jx.ExchangeConfig(JMode.PRISM_SIM, seq_axis="model",
                             seq_shards=2, L=L)
    want, _ = jreg.forward_fn(jcfg)(jp, {"tokens": tokens}, xsim)
    cache = jtfm.init_decode_cache(jcfg, B, N)
    dec, _ = jtfm.decode_step(jp, {"tokens": tokens[:, :1]}, cache, 0, jcfg,
                              jx.ExchangeConfig())
    want, dec = np.asarray(want), np.asarray(dec)
    for r in _runs(side, ckpt_dir, (2, 2)):
        i = r["coords"]["data"]
        rows = slice(i * B // 2, (i + 1) * B // 2)
        np.testing.assert_allclose(r["forward"]["logits"], want[rows],
                                   atol=2e-3)
        np.testing.assert_allclose(r["forward"]["decode"], dec[rows],
                                   atol=1e-4)


def _launch(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=timeout)


def test_launcher_trains_and_resumes_on_a_mesh(tmp_path):
    ck = str(tmp_path / "ck")
    out = _launch("--data", "2", "--ranks", "2", "--mode", "prism",
                  "--steps", "2", "--batch", "4", "--seq", "32",
                  "--ckpt-every", "2", "--ckpt-dir", ck)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == "TRAIN OK"
    assert any(ln.startswith("mesh {'data': 2, 'model': 2}") for ln in lines)
    assert any("the rows bit-identical" in ln for ln in lines)
    # two of the four ranks survive: the (1, 2) mesh resumes at step 2
    out = _launch("--data", "1", "--ranks", "2", "--mode", "prism",
                  "--steps", "3", "--batch", "4", "--seq", "32",
                  "--ckpt-dir", ck, "--resume")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "resumed at step 2" in out.stdout
    assert out.stdout.splitlines()[-1] == "TRAIN OK"


def test_launcher_refuses_tensor_parallelism(tmp_path):
    """Once a refusal naming ROADMAP [13.7]; now ``--mode local`` with a
    model axis over 1 trains with tensor parallelism over it and refuses
    nothing."""
    out = _launch("--data", "2", "--ranks", "2", "--mode", "local",
                  "--steps", "2", "--batch", "4", "--seq", "32",
                  "--ckpt-dir", str(tmp_path / "ck"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[13.7]" not in out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert lines[-1] == "TRAIN OK"
    assert any("tensor parallelism over model" in ln for ln in lines)
    assert any("the ranks holding each block bit-identical" in ln
               for ln in lines)
