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
``w_dq``/``w_dkv`` by columns, each rank's gradient its column block, the
norms whole and summed over the row; its experts split), whisper and the
vision model (the cross-attention split over the heads; the vision gates
at 0.5), hymba at 5/5 heads (split 3/2 by whole KV groups, its
``wq/wk/wv/wo`` moved between the JAX blocks and the head blocks; its
Mamba by inner channel, its MLP split), a llama of one KV head and 4
query heads (each rank 2 query heads of the shared KV head, ``wk``/``wv``
whole and sliced) and xLSTM (its mLSTM by value channel, its sLSTM by
head, its vocabulary split; at d 48 the sLSTM's FFN, 64 wide, split by
columns and rows too).  The tree the model runs on holds each split
leaf's block (half of it; the mLSTM's ``w_up`` its x half whole and half
its z half) and every other leaf whole.

The serving step builders under the ``local`` decode plan on the same
mesh, for MLA, the uneven hymba and xLSTM: the greedy tokens of
``build_decode_step`` equal one process's, and each rank's recurrent
cache holds its channels.
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
XLSTM_FFN = dict(d_model=48)     # the sLSTM's FFN int(4d/3) = 64 splits too

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
    "hymba": ("hymba-1.5b", HYMBA_UNEVEN, ("attn", "mlp", "vocab",
                                           "mamba")),
    "shared-kv": ("llama3.2-1b", SHARED_KV, ("attn", "mlp", "vocab")),
    "xlstm": ("xlstm-350m", {}, ("mlstm", "slstm", "vocab")),
    "xlstm-ffn": ("xlstm-350m", XLSTM_FFN, ("mlstm", "slstm", "vocab")),
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
SERVE = ("deepseek-v2", "hymba", "xlstm")
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
        raw_leaves=("w_dq", "w_dkv") if label == "deepseek-v2" else ())
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
    parent = key.rsplit("/", 2)[-2]
    if parent in ("mamba", "mlstm", "slstm"):
        return parent
    return "experts" if parent == "moe" else "mlp"


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
    family's heads, widths and vocabulary divide (the mixers': their
    channels; the mLSTM's ``w_up`` its x half whole and half its z half;
    MLA's latent projections half their columns)."""
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
                elif k.endswith("mlstm/w_up"):
                    assert got * 4 == of * 3, k
                else:
                    assert got * 2 == of, k
            else:
                assert held == tuple(whole), k
        assert bool(c["moved"]) == (label in ("hymba", "xlstm", "xlstm-ffn"))
        ffn = [k for k in c["tp_keys"]
               if k.endswith(("slstm/w_up", "slstm/w_down"))]
        assert len(ffn) == (2 if label == "xlstm-ffn" else 0)
        assert set(c["moved"]) <= set(c["tp_keys"])
        names = {k.rsplit("/", 1)[1] for k in c["sliced"]}
        assert names == {"qwen": {"bq", "bk", "bv"},
                         "shared-kv": {"wk", "wv"},
                         "xlstm": {"w_q", "w_k", "w_if", "b_if"},
                         "xlstm-ffn": {"w_q", "w_k", "w_if", "b_if"},
                         "deepseek-v2": {"scale"}}.get(label, set())
        if label == "deepseek-v2":
            assert {k.rsplit("/", 1)[1] for k in c["tp_keys"]
                    if _kind(k) == "attn"} == {"w_uq", "w_uk", "w_uv", "wo",
                                               "w_dq", "w_dkv"}


def test_mla_latent_projection_gradients_are_column_blocks(runs):
    """MLA's latent projections split by columns: each rank's gradient of
    ``w_dq`` and ``w_dkv``, before any sum over the mesh, is its column
    block's (half the columns), and the blocks joined in rank order are
    ``jax.value_and_grad``'s gradient within 2e-5 of its largest value;
    the row sums no projection gradient, only the norms'."""
    want = _RUN["deepseek-v2"][1]
    raw = [r["deepseek-v2"]["raw"] for r in runs]
    keys = sorted(raw[0])
    assert len(keys) == 4                      # both stacks' two leaves
    for k in keys:
        w = want[k]
        assert all(x[k].shape[-1] * 2 == w.shape[-1] for x in raw), k
        got = np.concatenate([x[k] for x in raw], axis=-1)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(got - w).max()) <= GRAD_RTOL * scale, k
    for r in runs:
        c = r["deepseek-v2"]
        assert not set(keys) & set(c["sliced"]) and set(keys) <= set(
            c["tp_keys"]) and not set(keys) & set(c["moved"])


def test_tp_recurrent_caches_hold_rank_channels(runs):
    """Under the ``local`` decode plan on (1, 2) each rank's recurrent
    cache holds its channels: hymba's Mamba state ``h [L, B, 80, S]`` and
    conv tail ``[L, B, W − 1, 80]`` of its 160 inner channels; xLSTM's
    mLSTM ``C`` its head of the 2 (``[G, 1, B, 1, 64, 64]``), ``n`` and
    ``m`` whole, its sLSTM states its head's 32 of the 64 channels."""
    for r in runs:
        hy, xl = (r["serve"][k]["cache_shapes"] for k in ("hymba", "xlstm"))
        B = SERVE_B
        assert hy["ssm"]["h"] == (2, B, 80, 8)
        assert hy["ssm"]["conv"] == (2, B, 3, 80)
        assert xl["m"]["C"] == (1, 1, B, 1, 64, 64)
        assert xl["m"]["n"] == (1, 1, B, 2, 64)
        assert xl["m"]["m"] == (1, 1, B, 2)
        assert all(xl["s"][k] == (1, B, 32) for k in ("c", "n", "h", "m"))


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
    heads and latent columns (the latent cache whole on both ranks),
    hymba's 3/2 heads (each rank's cache its KV heads) and its Mamba by
    channel, and xLSTM by channel and head give one process's greedy
    tokens; the held blocks widened over the row (3 and 2 heads gathered,
    a mixer's ranges put in place) are the whole params."""
    _, cfg, jp = _weights(label)
    want = _one_process_tokens(_serve_job(label, jp))
    kv = {"deepseek-v2": None, "hymba": (3, 2), "xlstm": None}[label]
    split = {"deepseek-v2": ("w_uq", "w_dq"), "hymba": ("wq", "w_in"),
             "xlstm": ("w_v", "w_x")}[label]
    for r in runs:
        got = r["serve"][label]
        np.testing.assert_array_equal(got["tokens"], want)
        assert got["widened"]        # the blocks gathered back, true sizes
        assert set(split) <= {k.rsplit("/", 1)[1] for k in got["tp_keys"]}
        if kv is not None:
            assert got["kv_heads"] == kv[r["coords"]["model"]]


@pytest.mark.parametrize("label", list(CASES))
def test_family_gathered_leaves_book_param_bytes(runs, label):
    """Every leaf the JAX plan shards over ``model`` that the port does not
    split, or whose head block is not the JAX block (hymba's 3/2 heads),
    is gathered whole over the row, booked as ``param``: (M − 1) halves of
    each in f32 (the reduced configs are f32), a layer's leaf in the
    layer's forward and again in its recompute (ZeRO-3 a layer at a
    time: the checkpoint keeps the blocks), a top-level one once."""
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
        want = sum(int(np.prod(w)) // 2 * 4 * (2 if c["leads"][k] else 1)
                   for k, w in c["whole_shapes"].items()
                   if "model" in spec[k] and (k not in c["tp_keys"]
                                              or k in c["moved"]))
        assert c["booked"]["model"]["param"] == want
        assert c["booked"]["data"]["param"] == 0
