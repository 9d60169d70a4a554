"""Tensor parallelism over the ``model`` axis of a ``("data", "model")``
mesh in the port, against the JAX package (CPU, reduced f32 configs, the
JAX weights carried across by the bridge; rank body
``tests/_torch_ranks.py:tp_mesh``; one (2, 2) spawn, then a (1, 2) spawn
that restores its checkpoint):

* the TP collectives (``copy_to``, ``reduce_from``, ``gather_from``,
  ``gather_to``): forward and backward against their definitions, bit for
  bit, with the ``tp`` bytes they book;
* llama and deepseek-moe under ``local`` on (2, 2) (heads, MLP columns,
  experts and vocabulary split over ``model``, the batch over ``data``),
  llama also in 2 microbatches: the loss within 1e-5 and the gradient,
  summed over the mesh and gathered whole, within 2e-5 of each leaf's
  largest value of ``jax.value_and_grad`` of the JAX ``loss_fn`` on the
  whole batch; the moe aux loss of the sharded batch equal to the whole
  batch's (≤ 1e-5); the bytes and calls booked by kind on each axis equal
  to a count from the shapes (``_train_oracle.zero3_count``: each layer
  gathered over ``data`` in its forward and its recompute, its gradient
  reduce-scattered as the backward leaves it; the loss's ``tp`` gather two
  numbers a token, no logits); on the dry run's count of the step, a
  layer adds to a rank's peak only its blocks' share; the same gradient
  bit for bit without rematerialisation, which gathers each layer once;
* the rank's blocks of the TP leaves between steps and the tree the model
  runs on: each TP leaf its 1/M block, every other leaf whole;
* one AdamW step against JAX's ``build_train_step``;
* the serving step builders (``build_prefill_step``,
  ``build_decode_step``) on (2, 2) under ``local`` and ``prism``, and
  under both with the ZeRO-3 plan (``fsdp``: the rank's blocks, each layer
  gathered as the loop reaches it), against the JAX package's on one
  device: the prefill's last logits within 2e-3, each decode step's
  within 1e-4, greedy tokens exact;
* a checkpoint saved on the TP (2, 2) mesh restored into (1, 2) and into
  one process;
* ``registry.prefill_fn`` / ``decode_fn`` against the JAX package's.

The launcher's ``--mode local --data 2 --ranks 2`` run is
``tests/test_torch_mesh_train.py::test_launcher_refuses_tensor_parallelism``.
"""
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
from repro.serving import engine as jengine
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

NAMES = ("data", "model")
LLAMA, MOE = "llama3.2-1b", "deepseek-moe-16b"
B, N = 4, 16
T0, STEPS, L = 8, 4, 2            # serving: prompt, greedy steps, means
GRAD_RTOL, LOSS_RTOL, STEP_RTOL = 2e-5, 1e-5, 1e-5
PARAM_ATOL, SURE, LR = 1e-6, 100.0, 1e-3
TRAIN = {"llama": LLAMA, "moe": MOE, "llama/accum2": LLAMA}
ACCUM = {"llama/accum2": 2}
SERVE = {"llama/local": (LLAMA, "local"), "llama/prism": (LLAMA, "prism"),
         "moe/local": (MOE, "local"), "llama/local/fsdp": (LLAMA, "local"),
         "llama/prism/fsdp": (LLAMA, "prism")}
RED = {"dtype": "float32"}
PEAK_SLACK = 0.01           # a layer's saved activations, in its peak


@pytest.fixture(scope="module")
def side():
    out = {}
    for arch in (LLAMA, MOE):
        jcfg, cfg = orc.configs(arch)
        jp, _ = orc.weights(jcfg, cfg)
        out[arch] = (jcfg, cfg, jp)
    return out


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tp_ckpt"))


_RUNS = {}


def _np_params(jp):
    return jax.tree.map(np.asarray, jp)


def _start(side, ckpt_dir):
    """Start the (2, 2) spawn and then the (1, 2) restore in the
    background, once; the JAX references are computed meanwhile."""
    if _RUNS:
        return
    cases = {}
    for label, arch in TRAIN.items():
        jcfg, cfg, jp = side[arch]
        cases[label] = dict(arch=arch, reduced=RED, params=_np_params(jp),
                            batch=orc.batch(cfg, B, N, seed=1), step=True,
                            no_remat=label == "llama",
                            accum=ACCUM.get(label, 1),
                            save=ckpt_dir if label == "llama" else None)
    serve = {}
    for label, (arch, mode) in SERVE.items():
        jcfg, cfg, jp = side[arch]
        serve[label] = dict(arch=arch, reduced=RED, mode=mode, L=L,
                            params=_np_params(jp), steps=STEPS,
                            fsdp=label.endswith("/fsdp"),
                            prompt=orc.batch(cfg, B, T0, seed=5)["tokens"])
    job = dict(collectives=7, cases=cases, serve=serve)

    def chain():
        _RUNS[(2, 2)] = spawn_mesh(_torch_ranks.tp_mesh, (2, 2), NAMES, job,
                                   timeout=300)
        _RUNS[(1, 2)] = spawn_mesh(
            _torch_ranks.tp_mesh, (1, 2), NAMES,
            dict(restore=ckpt_dir, restore_case=cases["llama"]),
            timeout=300)

    _RUNS["thread"] = _Runner(chain)


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
    _start(side, ckpt_dir)
    if shape not in _RUNS:
        t = _RUNS["thread"]
        t.join()
        if t.error is not None:
            raise t.error
    return _RUNS[shape]


def _keyed(tree):
    return {js._path_str(p): np.asarray(leaf, np.float32) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


_JAX = {}


def _jax_ref(side, label):
    """(loss, aux, gradient, stepped params, step metrics) of the JAX
    package on the whole batch under ``local``."""
    if label not in _JAX:
        jcfg, cfg, jp = side[TRAIN[label]]
        b = orc.to_jax(orc.batch(cfg, B, N, seed=1))
        (loss, parts), g = jax.jit(jax.value_and_grad(
            lambda p: jloss(p, b, jcfg, jx.ExchangeConfig()),
            has_aux=True))(jp)
        new, _, m = jax.jit(jbuild(jcfg, jx.ExchangeConfig(), JOpt(
            lr=LR, warmup_steps=1)))(jp, jinit(jp), b)
        _JAX[label] = (float(loss), float(parts["aux"]), _keyed(g),
                       _keyed(new), {k: float(v) for k, v in m.items()})
    return _JAX[label]


def test_tp_collectives_are_their_definitions(side, ckpt_dir):
    runs = _runs(side, ckpt_dir, (2, 2))
    for row in (runs[:2], runs[2:]):
        got = [r["collectives"] for r in row]
        ts = [c["t"] for c in got]
        cts = [c["ct"] for c in got]
        for p, c in enumerate(got):
            np.testing.assert_array_equal(c["copy_to"]["y"], ts[p])
            np.testing.assert_array_equal(c["copy_to"]["grad"], sum(cts))
            np.testing.assert_array_equal(c["reduce_from"]["y"], sum(ts))
            np.testing.assert_array_equal(c["reduce_from"]["grad"], cts[p])
            np.testing.assert_array_equal(c["gather_from"]["y"],
                                          np.concatenate(ts, -1))
            np.testing.assert_array_equal(c["gather_from"]["grad"],
                                          c["wide"][..., p * 5:(p + 1) * 5])
            n = ts[p].size * 4                     # f32, one peer
            assert c["copy_to"]["tp"] == n and c["copy_to"]["calls"] == 1
            assert c["reduce_from"]["tp"] == n
            assert c["gather_from"]["tp"] == n


def test_tp_gather_to_is_its_definition(side, ckpt_dir):
    """``gather_to``: the ranks' slices joined on the last dim forward; the
    backward the sum over the row of each rank's cotangent of this rank's
    slice (a reduce-scatter), each direction booking one peer's f32 slice
    as ``tp``."""
    runs = _runs(side, ckpt_dir, (2, 2))
    for row in (runs[:2], runs[2:]):
        got = [r["collectives"] for r in row]
        ts = [c["t"] for c in got]
        for p, c in enumerate(got):
            np.testing.assert_array_equal(c["gather_to"]["y"],
                                          np.concatenate(ts, -1))
            np.testing.assert_array_equal(
                c["gather_to"]["grad"],
                sum(o["wide"][..., p * 5:(p + 1) * 5] for o in got))
            n = ts[p].size * 4
            assert c["gather_to"]["tp"] == 2 * n
            assert c["gather_to"]["calls"] == 2


def test_gather_blocks_is_its_definition(side, ckpt_dir):
    """``SeqGroup.gather_blocks`` over the row, bit for bit: each piece the
    ranks' blocks joined along its dim (or stacked), one staged call a
    bucket (48-byte buckets here: the f32 [3, 4] piece alone, then the
    f32 [4] one with the bf16 one),
    booked as ``param`` with (P − 1) × the bucket's bytes; the backward
    the sum over the row of each rank's cotangent of this rank's block
    for the summed pieces (an f32 reduce-scatter a bucket that holds one,
    ``grad``), this rank's own block of its cotangent for the other."""
    runs = _runs(side, ckpt_dir, (2, 2))
    for row in (runs[:2], runs[2:]):
        got = [r["collectives"]["gather_blocks"] for r in row]
        P = len(got)
        for p, c in enumerate(got):
            np.testing.assert_array_equal(
                c["y"][0], np.concatenate([o["x"][0] for o in got], 0))
            np.testing.assert_array_equal(
                c["y"][1], np.concatenate([o["x"][1] for o in got], 1))
            np.testing.assert_array_equal(
                c["y"][2], np.stack([o["x"][2] for o in got]))
            np.testing.assert_array_equal(
                c["grad"][0], sum(o["ct"][0][p * 3:(p + 1) * 3]
                                  for o in got))
            np.testing.assert_array_equal(c["grad"][1],
                                          c["ct"][1][:, p * 5:(p + 1) * 5])
            np.testing.assert_array_equal(c["grad"][2],
                                          sum(o["ct"][2][p] for o in got))
            assert c["fwd"] == dict(param=(P - 1) * (48 + 16 + 20),
                                    calls=2)
            assert c["bwd"] == dict(grad=(P - 1) * (48 + 16), calls=2)


@pytest.mark.parametrize("label", list(TRAIN))
def test_tp_loss_and_gradients_match_jax(side, ckpt_dir, label):
    _start(side, ckpt_dir)
    want_loss, want_aux, want, _, _ = _jax_ref(side, label)
    runs = _runs(side, ckpt_dir, (2, 2))
    for r in runs:                    # summed over the column: the whole's
        np.testing.assert_allclose(r[label]["loss"], want_loss,
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r[label]["aux"], want_aux,
                                   rtol=LOSS_RTOL, atol=1e-12)
        assert r[label]["grad_digest"] == runs[0][label]["grad_digest"]
    got = runs[0][label]["grads"]
    assert got.keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        assert float(np.abs(got[k] - want[k]).max()) <= GRAD_RTOL * scale, k


def test_moe_aux_loss_of_a_sharded_batch_is_the_whole_batchs(side,
                                                             ckpt_dir):
    _, want_aux, _, _, _ = _jax_ref(side, "moe")
    assert want_aux > 0
    for r in _runs(side, ckpt_dir, (2, 2)):
        # the routing sums over the column inside the model: each rank's
        # share is half the whole batch's, and the column sums them
        np.testing.assert_allclose(r["moe"]["aux"], want_aux,
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["moe"]["metrics"]["aux"], want_aux,
                                   rtol=LOSS_RTOL)


def _specs(jcfg):
    """The JAX package's param specs of ``jcfg``'s ``local`` train plan on
    (2, 2), by JAX-layout key."""
    plan = js.make_plan(AbstractMesh((2, 2), NAMES), jcfg, JMode.LOCAL,
                        train=True)
    return {js._path_str(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_flatten_with_path(js.param_shardings(
                plan, jcfg, jreg.abstract_params(jcfg)))[0]}


@pytest.mark.parametrize("label", list(TRAIN))
def test_tp_blocks_are_the_ranks_model_blocks(side, ckpt_dir, label):
    """Between steps every leaf is held as its param-spec block (a TP leaf
    1/M over model); the tree the model runs on holds the TP leaves'
    model blocks and every other leaf whole."""
    jcfg, _, _ = side[TRAIN[label]]
    attn = {f"{s}/attn/{w}" for s in ("first_layers", "layers")
            for w in ("wq", "wk", "wv", "wo")}
    mlp = {f"{s}/{w}" for s in ("first_layers/mlp", "layers/moe")
           for w in ("w_up", "w_gate", "w_down")}
    want_tp = {"llama": {"embed/table"} | {
        f"layers/{w}" for w in ("attn/wq", "attn/wk", "attn/wv", "attn/wo",
                                "mlp/w_up", "mlp/w_gate", "mlp/w_down")},
        "moe": {"embed/table", "lm_head/table"} | attn | mlp}[
            label.split("/")[0]]
    spec = _specs(jcfg)
    for r in _runs(side, ckpt_dir, (2, 2)):
        c = r[label]
        assert set(c["tp_keys"]) == want_tp
        for k, whole in c["whole_shapes"].items():
            s = list(spec[k]) + [None] * len(whole)
            blk = tuple(n // (2 if s[i] else 1) for i, n in enumerate(whole))
            assert c["block_shapes"][k] == blk, k
            held = tuple(n // 2 if k in want_tp and s[i] == "model" else n
                         for i, n in enumerate(whole))
            assert c["held_shapes"][k] == held, k


def _want_bytes(cfg, jcfg, c, accum=1, remat=True):
    """Bytes and calls a rank of (2, 2) receives in the TP gradient, by
    axis and kind, from the shapes and the JAX specs: ``tp`` on the row
    (f32: the embedding's and every split region's sum of [b, N, d]
    forward, the backward's sum at every split region's input and the
    head's, a moe layer's routing weights [b, N, k] too, and the loss's
    gather of each rank's log-sum-exp and gold logit, [b, N, 2]: no
    logits cross the row), ``param`` and ``grad`` of the parameters
    (``_train_oracle.zero3_count``: each layer gathered over ``data`` in
    its forward and its recompute, the leaves the spec shards over
    ``model`` that the rank runs whole or moved gathered over the row;
    each gathered piece's gradient reduce-scattered once; the sliced
    leaves' row sum and the replicated leaves' column sum at the end; a
    moe layer's routing sums' cotangent), ``meta`` (the loss parts over
    the column, a moe layer's routing sums)."""
    D = M = 2
    b, d, V = B // D, cfg.d_model, cfg.vocab_size
    n_moe = (cfg.n_layers - cfg.moe.first_dense_layers) if cfg.moe else 0
    act = b * N * d * 4
    regions = 2 * cfg.n_layers                 # attention, then the MLP
    tp = (M - 1) * ((1 + regions) * act + (regions + 1) * act
                    + n_moe * b * N * cfg.moe.top_k * 4 if n_moe else
                    (1 + regions) * act + (regions + 1) * act)
    tp += (M - 1) * b * N * 2 * 4
    routing = n_moe * (D - 1) * 2 * cfg.moe.n_experts * 4 if n_moe else 0
    spec = _specs(jcfg)
    byts, calls = orc.zero3_count(
        c["whole_shapes"], spec, c["leads"], D, M, tied=cfg.tie_embeddings,
        tp_keys=c["tp_keys"], moved=c["moved"], sliced=c["sliced"],
        accum=accum, remat=remat)
    model = dict(tp=tp, grad=byts["model"]["grad"], meta=0,
                 param=byts["model"]["param"])
    data = dict(tp=0, grad=byts["data"]["grad"] + routing * accum,
                meta=(D - 1) * 12 + routing * accum,
                param=byts["data"]["param"])
    return {"model": model, "data": data}, calls


@pytest.mark.parametrize("label", list(TRAIN))
def test_tp_bytes_equal_the_shapes(side, ckpt_dir, label):
    jcfg, cfg, _ = side[TRAIN[label]]
    for r in _runs(side, ckpt_dir, (2, 2)):
        want, _ = _want_bytes(cfg, jcfg, r[label], ACCUM.get(label, 1))
        got = r[label]["booked"]
        for axis, kinds in want.items():
            assert {k: got[axis][k] for k in kinds} == kinds, (axis, label)
            assert all(v == 0 for k, v in got[axis].items()
                       if k not in kinds), (axis, got[axis])


@pytest.mark.parametrize("label", list(TRAIN))
def test_tp_param_and_grad_calls_equal_the_count(side, ckpt_dir, label):
    """The staged calls by axis and kind of the parameters' gathers and
    their gradients' sums equal the count from the shapes: one ``param``
    call over ``data`` a layer in the forward and one in the recompute,
    one a use of a top-level leaf; one ``grad`` reduce-scatter a gathered
    layer or use (each microbatch), and the end of the step's sums."""
    jcfg, cfg, _ = side[TRAIN[label]]
    for r in _runs(side, ckpt_dir, (2, 2)):
        _, want = _want_bytes(cfg, jcfg, r[label], ACCUM.get(label, 1))
        got = r[label]["calls"]
        for axis, kinds in want.items():
            have = {k: got.get(axis, {}).get(k, 0) for k in kinds}
            grad = dict(kinds)
            if TRAIN[label] == MOE:      # the routing sums' cotangents
                n_moe = cfg.n_layers - cfg.moe.first_dense_layers
                grad["grad"] += n_moe * (axis == "data")
            assert have == grad, (axis, label, have, grad)


@pytest.mark.parametrize("label", list(TRAIN))
def test_tp_step_holds_its_blocks_and_one_layer(side, ckpt_dir, label):
    """A rank holds its param-spec blocks (a TP leaf 1/M over model and
    1/D over data where its spec says) and one layer gathered: the
    gathered layer is freed as the layer ends, and the recompute gathers
    it again.  Counted on the dry run of the same step (``StepCounter``:
    every storage the step allocates, until it is freed): each layer
    added to the model adds to a (2, 2) rank's peak at most half what it
    adds to a (1, 2) rank with the same rows, which holds its TP blocks
    whole over ``data`` (``PEAK_SLACK``: the activations a layer saves,
    the same on both)."""
    arch, accum = TRAIN[label], ACCUM.get(label, 1)
    zero3 = orc.added_layer_bytes(arch, "train", (2, 2), "local", B=B, N=N,
                                  L=0, accum=accum)
    whole = orc.added_layer_bytes(arch, "train", (1, 2), "local", B=B // 2,
                                  N=N, L=0, accum=accum)
    assert 0 < zero3 <= whole / 2 * (1 + PEAK_SLACK), (zero3, whole)


def test_tp_gradient_without_remat_is_the_same(side, ckpt_dir):
    """Without rematerialisation the gradient is the same, bit for bit,
    and so are the bytes but the ``param`` gathers: each layer is
    gathered once, for the forward only."""
    jcfg, cfg, _ = side[LLAMA]
    for r in _runs(side, ckpt_dir, (2, 2)):
        c = r["llama"]
        assert c["no_remat"]["same"]
        once, _ = _want_bytes(cfg, jcfg, c, remat=False)
        for axis, kinds in c["booked"].items():
            want = dict(kinds, param=once[axis]["param"])
            assert c["no_remat"]["booked"][axis] == want, axis


@pytest.mark.parametrize("label", list(TRAIN))
def test_tp_adamw_step_matches_jax(side, ckpt_dir, label):
    runs = _runs(side, ckpt_dir, (2, 2))
    _, _, g, want, jm = _jax_ref(side, label)
    tm = runs[0][label]["metrics"]
    for k in ("loss", "nll", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=STEP_RTOL, atol=1e-7,
                                   err_msg=k)
    got, tg = runs[0][label]["params"], runs[0][label]["grads"]
    n_sure = 0
    for k in want:
        noise = max(float(np.abs(tg[k] - g[k]).max()), 1e-12)
        sure = (np.abs(g[k]) > SURE * noise) | ((g[k] == 0) & (tg[k] == 0))
        d = np.abs(got[k] - want[k])
        assert (d[sure] <= PARAM_ATOL).all(), (k, float(d[sure].max()))
        assert (d <= 2 * LR + PARAM_ATOL).all(), (k, float(d.max()))
        n_sure += int(sure.sum())
    assert n_sure > 0.9 * sum(v.size for v in want.values())
    held = {}
    for r in runs:
        assert r[label]["param_digest"] == runs[0][label]["param_digest"]
        for k, (where, dg) in r[label]["step_blocks"].items():
            held.setdefault((k, where), set()).add(dg)
    assert all(len(d) == 1 for d in held.values())


_JSERVE = {}


def _jax_serve(side, label):
    """The JAX package's step builders on one device: the prefill's last
    logits (``prism_sim`` for a ``prism`` plan, the per-partition oracle
    of its segment means), then the same teacher-forced and greedy decode
    steps from an empty cache → (prefill logits, each step's logits, the
    greedy tokens)."""
    if label not in _JSERVE:
        arch, mode = SERVE[label]
        jcfg, cfg, jp = side[arch]
        prompt = orc.batch(cfg, B, T0, seed=5)["tokens"]
        xf = (jx.ExchangeConfig(JMode.PRISM_SIM, seq_axis="model",
                                seq_shards=2, L=L) if mode == "prism"
              else jx.ExchangeConfig())
        with mock.patch.object(jx, "prism_prefill_attention", prism_oracle):
            first, _ = jengine.build_prefill_step(jcfg, xf)(
                jp, {"tokens": prompt},
                jtfm.init_decode_cache(jcfg, B, T0 + STEPS))
        step = jax.jit(jengine.build_decode_step(jcfg, jx.ExchangeConfig()),
                       static_argnums=())
        cache = jtfm.init_decode_cache(jcfg, B, T0 + STEPS)
        tok, logits, tokens = prompt[:, :1], [], []
        for i in range(T0 + STEPS - 1):
            lg, cache = step(jp, {"tokens": tok}, cache, i)
            logits.append(np.asarray(lg, np.float32))
            nxt = np.asarray(lg[:, -1]).argmax(-1)
            if i + 1 < T0:
                tok = prompt[:, i + 1:i + 2]
            else:
                tok = nxt[:, None].astype(prompt.dtype)
                tokens.append(nxt)
        _JSERVE[label] = (np.asarray(first, np.float32), np.stack(logits),
                          np.stack(tokens, 1))
    return _JSERVE[label]


@pytest.mark.parametrize("label", list(SERVE))
def test_step_builders_on_the_mesh_match_jax(side, ckpt_dir, label):
    _start(side, ckpt_dir)
    first, logits, tokens = _jax_serve(side, label)
    for r in _runs(side, ckpt_dir, (2, 2)):
        got = r["serve"][label]
        i = r["coords"]["data"]
        rows = slice(i * B // 2, (i + 1) * B // 2)
        np.testing.assert_allclose(got["prefill"], first[rows], atol=2e-3)
        np.testing.assert_allclose(got["logits"], logits[:, rows],
                                   atol=1e-4)
        np.testing.assert_array_equal(got["tokens"], tokens)
        assert got["tp_keys"], label          # something splits over model


@pytest.mark.parametrize("label", [k for k in SERVE if k.endswith("fsdp")])
def test_fsdp_serving_steps_hold_only_the_blocks(side, ckpt_dir, label):
    """Under a plan with ``fsdp`` (ZeRO-3 over ``data``) the serving steps
    take the rank's param-spec blocks (half of each leaf the spec shards
    over ``data``), gather each layer as the loop reaches it (a view a
    step) and free it as the layer ends (the prefill under ``prism``
    gathers it whole over the row too): on the dry run's count of each
    step (``StepCounter``), a layer added to the model adds nothing to
    the rank's peak, as under the plan without ``fsdp``, whose whole
    params are the step's arguments."""
    for r in _runs(side, ckpt_dir, (2, 2)):
        got = r["serve"][label]
        shapes = got["whole_shapes"]
        assert got["views"] == 1 + T0 + STEPS - 1      # prefill, steps
        halved = [k for k, w in shapes.items() if got["held"][k] != w]
        assert halved and all(int(np.prod(got["held"][k])) * 2 <=
                              int(np.prod(shapes[k])) for k in halved)
    arch, mode = SERVE[label]
    for kind in ("prefill", "decode"):
        added = orc.added_layer_bytes(arch, kind, (2, 2), mode, B=B, N=T0,
                                      L=L, fsdp=True)
        assert added == orc.added_layer_bytes(arch, kind, (2, 2), mode, B=B,
                                              N=T0, L=L) == 0, kind


def test_registry_step_functions_match_jax(side):
    from repro_torch.configs import get_config
    from repro_torch.core.exchange import ExchangeConfig
    from repro_torch.models import transformer as tfm
    jcfg, cfg, jp = side[LLAMA]
    _, tparams = orc.weights(jcfg, cfg)
    prompt = orc.batch(cfg, 2, 6, seed=3)["tokens"]
    want, _ = jreg.prefill_fn(jcfg)(jp, {"tokens": prompt},
                                    jx.ExchangeConfig())
    got, _ = registry.prefill_fn(cfg)(
        tparams, orc.to_torch({"tokens": prompt}), ExchangeConfig())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    want, _ = jreg.decode_fn(jcfg)(jp, {"tokens": prompt[:, :1]},
                                   jtfm.init_decode_cache(jcfg, 2, 6), 0,
                                   jx.ExchangeConfig())
    got, _ = registry.decode_fn(cfg)(
        tparams, orc.to_torch({"tokens": prompt[:, :1]}),
        tfm.init_decode_cache(cfg, 2, 6, device="cpu"), 0, ExchangeConfig())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError, match="encoder-only"):
        registry.decode_fn(get_config("vit-base-16"))


def test_elastic_remesh_takes_a_local_plan(side):
    """Losing two of four ranks under ``local``: the survivors' mesh is
    (1, 2), its plan splits over ``model``, and each survivor's Placement
    holds its TP blocks (the blocks a resumed run restores)."""
    from repro_torch.runtime.elastic import ElasticMeshManager
    _, cfg, _ = side[LLAMA]
    mesh, plan = ElasticMeshManager(cfg, TMode.LOCAL,
                                    devices=[0, 1, 2, 3]).drop([2, 3])
    assert dict(mesh.shape) == {"data": 1, "model": 2}
    assert plan.seq_axis is None
    for m in range(2):
        place = Placement(plan, cfg, registry.abstract_params(cfg),
                          coords={"data": 0, "model": m})
        assert "layers/attn/wq" in place.tp_dim
        wq = place.index_of["layers/attn/wq"].shape
        assert place.block_shape("layers/attn/wq", place.spec[
            "layers/attn/wq"]) == wq[:-1] + (wq[-1] // 2,)


def test_tp_checkpoint_moves_between_meshes(side, ckpt_dir):
    """Saved from the TP (2, 2) mesh after one step: restored into (1, 2)
    (each rank its TP blocks) and into one process (the global arrays),
    bit for bit."""
    saved = _runs(side, ckpt_dir, (2, 2))[0]["llama"]
    for r in _runs(side, ckpt_dir, (1, 2)):
        got = r["restored"]
        assert got["step"] == 1 and got["tp_keys"]
        for k, idx in got["index"].items():
            np.testing.assert_array_equal(got["params"][k],
                                          saved["params"][k][idx])
            np.testing.assert_array_equal(got["m"][k],
                                          saved["m"][k][got["opt_index"][k]])
    _, cfg, _ = side[LLAMA]
    place = Placement(make_plan(make_auto_mesh((1, 1), NAMES), cfg,
                                TMode.LOCAL, train=True),
                      cfg, registry.abstract_params(cfg),
                      coords={"data": 0, "model": 0})
    template, _ = place.state_template()
    params, opt = load_pytree(template, ckpt_dir, device="cpu")
    assert int(opt.step) == 1
    for k in place.keys:
        np.testing.assert_array_equal(params[k].numpy(), saved["params"][k])
        np.testing.assert_array_equal(opt.v[k].numpy(), saved["v"][k])
