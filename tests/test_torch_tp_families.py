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
split, the router and the shared expert whole), deepseek-v2 (MLA split
by heads: ``w_uq``'s columns, ``w_uk``/``w_uv``'s heads, ``wo``'s rows;
``w_dq``/``w_dkv`` whole, their gradients the same on both ranks with no
row sum; its experts split), whisper and the vision model (the
cross-attention split over the heads; the vision gates at 0.5), hymba at
5/5 heads (split 3/2 by whole KV groups, its ``wq/wk/wv/wo`` moved
between the JAX blocks and the head blocks; its Mamba gathered, its MLP
split), a llama of one KV head and 4 query heads (each rank 2 query heads
of the shared KV head, ``wk``/``wv`` whole and sliced) and xLSTM (its
projections gathered, its vocabulary split).  The tree the model runs on
holds each split leaf's head block (or half) and every other leaf whole.

The serving step builders under the ``local`` decode plan on the same
mesh, for MLA and the uneven hymba: the greedy tokens of
``build_decode_step`` equal one process's.
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
HYMBA_UNEVEN = dict(n_heads=5, n_kv_heads=5, d_model=80)    # 3 + 2 heads
SHARED_KV = dict(n_heads=4, n_kv_heads=1)        # 2 query heads of 1 a rank

# label → (arch, reduced overrides, the leaves that split over model)
CASES = {
    "llama": ("llama3.2-1b", {}, ("attn", "mlp", "vocab")),
    "internlm2": ("internlm2-1.8b", {}, ("attn", "mlp", "vocab")),
    "qwen": ("qwen1.5-32b", {}, ("attn", "mlp", "vocab")),
    "gemma2": ("gemma2-27b", {}, ("attn", "mlp", "vocab")),
    "deepseek-moe": ("deepseek-moe-16b", {}, ("attn", "mlp", "experts",
                                              "vocab")),
    "deepseek-v2": ("deepseek-v2-236b", {}, ("attn", "mlp", "experts",
                                            "vocab")),
    "whisper": ("whisper-large-v3", {}, ("attn", "mlp", "vocab")),
    "vision": ("llama-3.2-vision-11b", {}, ("attn", "mlp", "vocab")),
    "hymba": ("hymba-1.5b", HYMBA_UNEVEN, ("attn", "mlp", "vocab")),
    "shared-kv": ("llama3.2-1b", SHARED_KV, ("attn", "mlp", "vocab")),
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


# the serving step builders under ``local`` on the same mesh: the prompt
# teacher-forced, then SERVE_STEPS greedy tokens
SERVE = ("deepseek-v2", "hymba")
SERVE_B, SERVE_T0, SERVE_STEPS = 2, 4, 4
_RUN = {}


def _serve_job(label, jp):
    arch, over, _ = CASES[label]
    prompt = np.random.RandomState(5).randint(
        0, 512, (SERVE_B, SERVE_T0)).astype(np.int32)
    return dict(arch=arch, reduced={"dtype": "float32", **over}, params=jp,
                mode="local", prompt=prompt, steps=SERVE_STEPS)


@pytest.fixture(scope="module")
def runs():
    """The spawn in a thread while the JAX references are computed."""
    sides = {label: _weights(label) for label in CASES}
    job = dict(cases={label: dict(
        arch=CASES[label][0], reduced={"dtype": "float32",
                                       **CASES[label][1]},
        params=jp, batch=orc.batch(cfg, B, N, seed=3),
        raw_digest=label == "deepseek-v2")
        for label, (jcfg, cfg, jp) in sides.items()},
        serve={label: _serve_job(label, sides[label][2]) for label in SERVE})
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


def _head_width(key, cfg):
    """An attention leaf's split dim's width a head (and whether it is a
    KV leaf), from the config alone."""
    name = key.rsplit("/", 1)[1]
    if cfg.mla is not None:
        m = cfg.mla
        return {"w_uq": m.qk_nope_dim + m.qk_rope_dim, "w_uk": 1, "w_uv": 1,
                "wo": m.v_head_dim}[name], False
    return cfg.hd, name in ("wk", "wv")


@pytest.mark.parametrize("label", list(CASES))
def test_family_tp_splits_what_divides(runs, label):
    """Each split leaf is held as its block on its split dim in the tree
    the model runs on: half of it, or for the attention its rank's heads
    (hymba at 5/5: 3 heads on rank 0, 2 on rank 1, moved from the JAX
    spec's halves; one KV head: 2 query heads a rank, ``wk``/``wv`` whole
    and sliced); every other leaf whole; the split kinds are the ones the
    family's heads, widths and vocabulary divide."""
    _, cfg, _ = _weights(label)
    uneven = {"hymba": ((3, 3), (2, 2))}.get(label)   # (query, KV) a rank
    for r in runs:
        c, rank = r[label], r["coords"]["model"]
        assert {_kind(k) for k in c["tp_keys"]} == set(CASES[label][2])
        for k, whole in c["whole_shapes"].items():
            held = c["held_shapes"][k]
            halved = [i for i, (h, w) in enumerate(zip(held, whole))
                      if h != w]
            if k in c["tp_keys"]:
                assert len(halved) == 1, k
                got, of = held[halved[0]], whole[halved[0]]
                if uneven and _kind(k) == "attn":
                    width, kv = _head_width(k, cfg)
                    assert got == uneven[rank][kv] * width, k
                else:
                    assert got * 2 == of, k
            else:
                assert held == tuple(whole), k
        assert bool(c["moved"]) == (label == "hymba")
        assert set(c["moved"]) <= set(c["tp_keys"])
        names = {k.rsplit("/", 1)[1] for k in c["sliced"]}
        assert names == {"qwen": {"bq", "bk", "bv"},
                         "shared-kv": {"wk", "wv"}}.get(label, set())
        if label == "deepseek-v2":
            assert {k.rsplit("/", 1)[1] for k in c["tp_keys"]
                    if _kind(k) == "attn"} == {"w_uq", "w_uk", "w_uv", "wo"}


def test_mla_latent_projections_whole_with_no_row_sum(runs):
    """MLA's latent projections and norms are whole on both ranks: their
    gradients before any sum are the same bits on both, and the row sums
    no gradient (its latent's cotangent is summed in the backward)."""
    raw = [r["deepseek-v2"]["raw"] for r in runs]
    keys = {k for k in raw[0] if k.rsplit("/", 1)[1] in ("w_dq", "w_dkv")}
    assert len(keys) == 4                      # both stacks' two leaves
    assert raw[0] == raw[1]
    for r in runs:
        assert r["deepseek-v2"]["booked"]["model"]["grad"] == 0
        assert r["deepseek-v2"]["booked"]["model"]["tp"] > 0


def _one_process_tokens(c):
    """``_torch_ranks._tp_serve_case``'s loop in this process on the whole
    params without a plan → the greedy tokens."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.exchange import ExchangeConfig
    from repro_torch.models import transformer as tfm
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.serving import engine
    cfg = get_config(c["arch"]).reduced(**c["reduced"])
    params = params_from_numpy(c["params"], cfg, device="cpu")
    prompt = torch.from_numpy(c["prompt"])
    B, T0 = prompt.shape
    S = T0 + c["steps"]
    step = engine.build_decode_step(cfg, ExchangeConfig())
    cache = tfm.init_decode_cache(cfg, B, S)
    tok, tokens = prompt[:, :1], []
    with torch.no_grad():
        for i in range(S - 1):
            lg, cache = step(params, {"tokens": tok}, cache, i)
            got = lg[:, -1].argmax(-1)
            tok = prompt[:, i + 1:i + 2] if i + 1 < T0 else \
                got[:, None].to(prompt.dtype)
            if i + 1 >= T0:
                tokens.append(got.numpy())
    return np.stack(tokens, 1)


@pytest.mark.parametrize("label", SERVE)
def test_tp_decode_greedy_tokens_match_one_process(runs, label):
    """``build_decode_step`` under the ``local`` plan on (1, 2): MLA by
    heads (the latent cache whole on both ranks) and hymba's 3/2 heads
    (each rank's cache its KV heads) give one process's greedy tokens;
    the held blocks widened over the row (3 and 2 heads gathered) are the
    whole params."""
    _, cfg, jp = _weights(label)
    want = _one_process_tokens(_serve_job(label, jp))
    kv = {"deepseek-v2": None, "hymba": (3, 2)}[label]
    for r in runs:
        got = r["serve"][label]
        np.testing.assert_array_equal(got["tokens"], want)
        assert got["widened"]        # the blocks gathered back, true sizes
        assert any(k.rsplit("/", 1)[1] in ("w_uq", "wq")
                   for k in got["tp_keys"])
        if kv is not None:
            assert got["kv_heads"] == kv[r["coords"]["model"]]


@pytest.mark.parametrize("label", list(CASES))
def test_family_gathered_leaves_book_param_bytes(runs, label):
    """Every leaf the JAX plan shards over ``model`` that the port does not
    split, or whose head block is not the JAX block (hymba's 3/2 heads),
    is gathered whole over the row, booked as ``param``: (M − 1) halves of
    each in f32 (the reduced configs are f32)."""
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
                   if "model" in spec[k] and (k not in c["tp_keys"]
                                              or k in c["moved"]))
        assert c["booked"]["model"]["param"] == want
        assert c["booked"]["data"]["param"] == 0
