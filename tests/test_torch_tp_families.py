"""Tensor parallelism over ``model`` for every LM family of the port
against the JAX package (CPU, reduced f32 configs, the JAX weights carried
across by the bridge; one (1, 2) spawn, rank body
``tests/_torch_ranks.py:tp_mesh``).

Each family's ``local`` train step on the (1, 2) mesh: the loss within
1e-5 and the gradient (summed over the mesh, gathered whole) within 2e-5
of each leaf's largest value of ``jax.value_and_grad`` of the JAX
``loss_fn`` on the whole batch.  The cases: llama, internlm2, qwen with
its qkv biases (gathered whole, each rank its heads' slice, summed over
the row), gemma2 (the window, the softcaps), deepseek-moe (the experts
split, the router and the shared expert whole), deepseek-v2 (MLA's
projections gathered, its experts split), whisper and the vision model
(the cross-attention split over the heads; the vision gates at 0.5),
hymba at 5/5 heads (its attention and Mamba gathered, its MLP split) and
xLSTM (its projections gathered, its vocabulary split).  The tree the
model runs on holds each split leaf's half and every other leaf whole.
"""
import concurrent.futures

import jax
import numpy as np
import pytest

import _torch_ranks
import _train_oracle as orc
from repro.core import exchange as jx
from repro.sharding import specs as js
from repro.train.train_step import loss_fn as jloss
from repro_torch.core.seq_group import spawn_mesh

B, N = 2, 16
GRAD_RTOL, LOSS_RTOL = 2e-5, 1e-5
GATE = 0.5                 # the vlm's gates: tanh(0) erases the memory
HYMBA_GATHERED = dict(n_heads=5, n_kv_heads=5, d_model=80)

# label → (arch, reduced overrides, the leaves that split over model)
CASES = {
    "llama": ("llama3.2-1b", {}, ("attn", "mlp", "vocab")),
    "internlm2": ("internlm2-1.8b", {}, ("attn", "mlp", "vocab")),
    "qwen": ("qwen1.5-32b", {}, ("attn", "mlp", "vocab")),
    "gemma2": ("gemma2-27b", {}, ("attn", "mlp", "vocab")),
    "deepseek-moe": ("deepseek-moe-16b", {}, ("attn", "mlp", "experts",
                                              "vocab")),
    "deepseek-v2": ("deepseek-v2-236b", {}, ("mlp", "experts", "vocab")),
    "whisper": ("whisper-large-v3", {}, ("attn", "mlp", "vocab")),
    "vision": ("llama-3.2-vision-11b", {}, ("attn", "mlp", "vocab")),
    "hymba": ("hymba-1.5b", HYMBA_GATHERED, ("mlp", "vocab")),
    "xlstm": ("xlstm-350m", {}, ("vocab",)),
}


def _weights(label):
    arch, over, _ = CASES[label]
    jcfg, cfg = orc.configs(arch, **over)
    jp = jax.tree.map(np.asarray, orc.weights(jcfg, cfg)[0])
    if cfg.family == "vlm":
        jp = dict(jp, cross_layers=dict(
            jp["cross_layers"], gate=jp["cross_layers"]["gate"] + GATE))
    return jcfg, cfg, jp


_RUN = {}


@pytest.fixture(scope="module")
def runs():
    """The spawn in a thread while the JAX references are computed."""
    sides = {label: _weights(label) for label in CASES}
    job = dict(cases={label: dict(
        arch=CASES[label][0], reduced={"dtype": "float32",
                                       **CASES[label][1]},
        params=jp, batch=orc.batch(cfg, B, N, seed=3))
        for label, (jcfg, cfg, jp) in sides.items()})
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(spawn_mesh, _torch_ranks.tp_mesh, (1, 2),
                        ("data", "model"), job, timeout=400)
        for label, (jcfg, cfg, jp) in sides.items():
            b = orc.to_jax(orc.batch(cfg, B, N, seed=3))
            (loss, _), g = jax.jit(jax.value_and_grad(
                lambda p: jloss(p, b, jcfg, jx.ExchangeConfig()),
                has_aux=True))(jax.tree.map(np.asarray, jp))
            _RUN[label] = (float(loss), {
                js._path_str(p): np.asarray(leaf, np.float32) for p, leaf in
                jax.tree_util.tree_flatten_with_path(g)[0]})
        return fut.result()


@pytest.mark.parametrize("label", list(CASES))
def test_family_tp_loss_and_gradients_match_jax(runs, label):
    want_loss, want = _RUN[label]
    for r in runs:
        np.testing.assert_allclose(r[label]["loss"], want_loss,
                                   rtol=LOSS_RTOL)
        assert r[label]["grad_digest"] == runs[0][label]["grad_digest"]
    got = runs[0][label]["grads"]
    assert got.keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        assert float(np.abs(got[k] - want[k]).max()) <= GRAD_RTOL * scale, k


def _kind(key: str) -> str:
    if key.endswith("/table"):
        return "vocab"
    if "/attn/" in key or "/xattn/" in key:
        return "attn"
    return "experts" if key.rsplit("/", 2)[-2] == "moe" else "mlp"


@pytest.mark.parametrize("label", list(CASES))
def test_family_tp_splits_what_divides(runs, label):
    """Each split leaf is held as its half on its split dim in the tree
    the model runs on; every other leaf whole; the split kinds are the
    ones the family's heads, widths and vocabulary divide."""
    for r in runs:
        c = r[label]
        assert {_kind(k) for k in c["tp_keys"]} == set(CASES[label][2])
        for k, whole in c["whole_shapes"].items():
            held = c["held_shapes"][k]
            halved = [i for i, (h, w) in enumerate(zip(held, whole))
                      if h != w]
            if k in c["tp_keys"]:
                assert len(halved) == 1 and \
                    held[halved[0]] * 2 == whole[halved[0]], k
            else:
                assert held == tuple(whole), k
        if label == "qwen":
            assert {k.rsplit("/", 1)[1] for k in c["sliced"]} == \
                {"bq", "bk", "bv"}
        else:
            assert c["sliced"] == []


@pytest.mark.parametrize("label", list(CASES))
def test_family_gathered_leaves_book_param_bytes(runs, label):
    """Every leaf the JAX plan shards over ``model`` that the port does not
    split is gathered whole over the row, booked as ``param``: (M − 1)
    halves of each in f32 (the reduced configs are f32)."""
    from jax.sharding import AbstractMesh
    from repro.core.exchange import ExchangeMode as JMode
    from repro.models import registry as jreg
    jcfg, _, _ = _weights(label)
    plan = js.make_plan(AbstractMesh((1, 2), ("data", "model")), jcfg,
                        JMode.LOCAL, train=True)
    spec = {js._path_str(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_flatten_with_path(js.param_shardings(
                plan, jcfg, jreg.abstract_params(jcfg)))[0]}
    for r in runs:
        c = r[label]
        want = sum(int(np.prod(w)) // 2 * 4
                   for k, w in c["whole_shapes"].items()
                   if "model" in spec[k] and k not in c["tp_keys"])
        assert c["booked"]["model"]["param"] == want
        assert c["booked"]["data"]["param"] == 0
