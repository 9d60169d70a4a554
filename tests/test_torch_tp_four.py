"""Tensor parallelism over ``model`` past two model ranks: one (1, 4)
spawn (rank body ``tests/_torch_ranks.py:tp_mesh``, as
``tests/test_torch_tp_families.py``) against the JAX package (CPU,
reduced f32 configs, the JAX weights carried across by the bridge).

Each case's ``local`` train step on the (1, 4) mesh: the loss within 1e-5
and the gradient (summed over the mesh, gathered whole) within 2e-5 of
each leaf's largest value of ``jax.value_and_grad`` of the JAX
``loss_fn`` on the whole batch.  The cases reach what M = 2 does not:

* hymba at 5/5 heads and d 80: heads 2 + 1 + 1 + 1 by whole KV groups,
  its Mamba 40 inner channels a rank;
* llama at 4/2 heads: each KV head shared by a pair of ranks (``wk/wv``
  whole, each rank its slice, summed over the row);
* xLSTM: its 2 mLSTM heads on 4 ranks, so a head's value channels span
  two ranks (the groupnorm's mean of squares a row sum); its sLSTM whole,
  as 4 does not divide its 2 heads;
* deepseek-v2: MLA one head a rank, its latents 12 + 10 columns a rank
  (``w_dq``, ``w_dkv``), gathered over the row before their norms.
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
M = 4
GRAD_RTOL, LOSS_RTOL = 2e-5, 1e-5
TIMEOUT_S = 300

# label → (arch, reduced overrides)
CASES = {
    "hymba": ("hymba-1.5b", dict(n_heads=5, n_kv_heads=5, d_model=80)),
    "shared-kv": ("llama3.2-1b", dict(n_heads=4, n_kv_heads=2)),
    "xlstm": ("xlstm-350m", {}),
    "deepseek-v2": ("deepseek-v2-236b", {}),
}
_RUN = {}


def _weights(label):
    arch, over = CASES[label]
    jcfg, cfg = orc.configs(arch, **over)
    return jcfg, cfg, jax.tree.map(np.asarray, orc.weights(jcfg, cfg)[0])


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
        fut = ex.submit(spawn_mesh, _torch_ranks.tp_mesh, (1, M),
                        ("data", "model"), job, timeout=TIMEOUT_S)
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
def test_tp_four_ranks_loss_and_gradients_match_jax(runs, label):
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


# label → {parent/leaf: (its split dim's width a rank, by model rank)}
BLOCKS = {
    "hymba": {"attn/wq": (32, 16, 16, 16), "mamba/w_out": (40,) * M,
              "mamba/w_in": (80,) * M, "mamba/w_bc": (40,) * M},
    "shared-kv": {"attn/wq": (16,) * M, "attn/wk": (32,) * M},
    "xlstm": {"mlstm/w_v": (32,) * M, "mlstm/w_up": (128 + 32,) * M,
              "mlstm/w_q": (128,) * M, "slstm/w_x": (256,) * M},
    "deepseek-v2": {"attn/w_dq": (12,) * M, "attn/w_dkv": (10,) * M,
                    "attn/w_uq": (24,) * M},
}


@pytest.mark.parametrize("label", list(CASES))
def test_tp_four_ranks_hold_their_blocks(runs, label):
    """The tree each rank runs on holds its block of each split leaf
    (hymba's uneven heads, the shared KV head whole, the mLSTM's values
    a quarter and its x half of ``w_up`` whole, the sLSTM whole, MLA's
    latents a quarter); the row sums the gradients of the leaves whose
    gradient is a rank's part."""
    sliced = {"shared-kv": {"wk", "wv"},
              "xlstm": {"w_q", "w_k", "w_if", "b_if"},
              "deepseek-v2": {"scale"}}.get(label, set())
    for r in runs:
        c, rank = r[label], r["coords"]["model"]
        for k, held in c["held_shapes"].items():
            name = "/".join(k.split("/")[-2:])
            if name in BLOCKS[label]:
                whole = c["whole_shapes"][k]
                dim = next((i for i, (h, w) in enumerate(zip(held, whole))
                            if h != w), len(whole) - 1)
                assert held[dim] == BLOCKS[label][name][rank], k
        assert {k.rsplit("/", 1)[1] for k in c["sliced"]} == sliced
        assert c["booked"]["model"]["tp"] > 0
