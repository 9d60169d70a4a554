"""The head rule of tensor parallelism over ``model``
(``repro_torch.models.tp.head_split`` and ``TPPlan.leaf_block``), pure
functions, on every arch at full width × a model axis of 2, 4 and 16,
against the JAX package's sharding specs (``repro.sharding.specs``):

* the query heads of the ranks tile the heads in order, each rank's query
  heads read only its KV heads with one group size, and the KV heads are
  split whole (or one shared by ``M / n_kv`` ranks);
* the rule splits exactly where the divisibility of the heads says;
* a rank's block of an attention leaf is the JAX spec's ``model`` block
  wherever M divides the query heads and the spec shards the leaf over
  ``model``; it differs (the port moves the leaf over the row) only where
  the heads split unevenly or the spec does not shard the leaf; MLA's
  latent projections split by columns, the JAX blocks, wherever the heads
  split and M divides the latent, and their norms are summed over the row.
"""
import jax
import pytest

from repro.configs import get_config as jget
from repro.core.exchange import ExchangeMode as JMode
from repro.models import registry as jreg
from repro.sharding import specs as js
from jax.sharding import AbstractMesh
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.models.tp import Heads, TPPlan, head_split

MODEL_AXES = (2, 4, 16)
_Q = {"wq", "wo", "w_uq", "w_uk", "w_uv"}        # leaves split by query heads
_LATENT = {"w_dq", "w_dkv"}                      # MLA's, split by columns


def _one(block):
    """``leaf_block``'s (dim, ranges) of one range → (dim, start, stop)."""
    if block is None:
        return None
    dim, ranges = block
    assert len(ranges) == 1
    return (dim,) + tuple(ranges[0])


def _case(H: int, Hk: int, M: int) -> str:
    """Which rule splits H/Hk heads on M ranks, from divisibility alone."""
    if Hk % M == 0:
        return "i"
    if Hk >= M:
        return "ii"
    if M % Hk == 0 and (H // Hk) % (M // Hk) == 0:
        return "iii"
    return "iv"


@pytest.mark.parametrize("M", MODEL_AXES)
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_head_split_tiles_the_heads(arch, M):
    cfg = get_config(arch)
    H, Hk = cfg.n_heads, cfg.n_kv_heads
    G = H // Hk
    case = _case(H, Hk, M)
    got = [head_split(H, Hk, M, r) for r in range(M)]
    if case == "iv":
        assert got == [None] * M
        return
    assert all(isinstance(h, Heads) for h in got)
    assert [h.q0 for h in got] == [sum(g.n_q for g in got[:r])
                                   for r in range(M)]
    assert sum(h.n_q for h in got) == H
    for r, h in enumerate(got):
        assert h.n_q > 0 and h.n_q % h.n_kv == 0
        g = h.n_q // h.n_kv                      # the rank's group size
        for j in range(h.n_q):                   # the kernels' GQA mapping
            assert (h.q0 + j) // G == h.kv0 + j // g
        assert h.shared == (case == "iii")
    if case == "iii":
        assert {h.n_q for h in got} == {H // M}
        assert [h.kv0 for h in got] == [r // (M // Hk) for r in range(M)]
    else:
        assert [h.kv0 for h in got] == [sum(g.n_kv for g in got[:r])
                                        for r in range(M)]
        sizes = [h.n_kv for h in got]
        assert sizes == sorted(sizes, reverse=True)
        assert max(sizes) - min(sizes) == (0 if case == "i" else 1)


def _attention_leaves(jcfg):
    """(key, shape) of every attention leaf of the JAX layout."""
    return [(js._path_str(p), tuple(leaf.shape)) for p, leaf in
            jax.tree_util.tree_flatten_with_path(
                jreg.abstract_params(jcfg))[0]
            if js._path_str(p).rsplit("/", 2)[-2] in ("attn", "xattn")]


@pytest.mark.parametrize("M", MODEL_AXES)
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_leaf_blocks_against_jax_specs(arch, M):
    jcfg, cfg = jget(arch), get_config(arch)
    plan = js.make_plan(AbstractMesh((1, M), ("data", "model")), jcfg,
                        JMode.LOCAL, train=True)
    tp = TPPlan(M, full=True)
    case = _case(cfg.n_heads, cfg.n_kv_heads, M)
    for key, shape in _attention_leaves(jcfg):
        name = key.rsplit("/", 1)[1]
        spec = tuple(js._leaf_spec(key, jax.ShapeDtypeStruct(shape,
                                                             "float32"),
                                   plan, jcfg))
        blocks = [_one(tp.leaf_block(key, shape, cfg, r)) for r in range(M)]
        sliced = [tp.sliced_dim(key, shape, cfg, r) for r in range(M)]
        if cfg.mla is not None and case != "iv" and name in _LATENT:
            n = shape[-1]
            want = [(len(shape) - 1, r * n // M, (r + 1) * n // M)
                    for r in range(M)] if n % M == 0 else [None] * M
            assert blocks == want, key
            assert spec[-1] == ("model" if n % M == 0 else None), key
            continue
        if cfg.mla is not None and case != "iv" and key.rsplit(
                "/", 2)[-2] in ("q_norm", "kv_norm"):
            m = cfg.mla
            n = m.q_lora_rank if "q_norm" in key else \
                m.kv_lora_rank + m.qk_rope_dim
            assert blocks == [None] * M, key
            assert sliced == [len(shape) - 1 if n % M == 0 else None] * M
            continue
        if case == "iv" or name not in _Q | {"wk", "wv"}:
            assert blocks == [None] * M, key     # whole (norms, biases...)
            if case == "iv":
                assert sliced == [None] * M, key
            continue
        if case == "iii" and name in ("wk", "wv"):
            assert blocks == [None] * M and sliced == [len(shape) - 1] * M
            continue
        dim = blocks[0][0]
        assert {b[0] for b in blocks} == {dim}
        assert [b[1] for b in blocks] == [0] + [b[2] for b in blocks[:-1]]
        assert blocks[-1][2] == shape[dim], key
        n = shape[dim]
        jax_blocks = [(r * n // M, (r + 1) * n // M) for r in range(M)]
        same = spec[dim] == "model" and \
            [b[1:] for b in blocks] == jax_blocks
        divides = (cfg.n_heads if name in _Q else cfg.n_kv_heads) % M == 0
        # the JAX block is the head block exactly where M divides the heads
        assert same == (divides and spec[dim] == "model"), (key, spec)
        if divides:
            assert spec[dim] == "model", (key, spec)


def test_head_split_examples():
    """The splits named for the production configs: hymba-1.5b's 25/5 on
    2 ranks, qwen1.5-32b's 40/40 on 16, the vision model's 32/8 on 16."""
    assert [head_split(25, 5, 2, r) for r in (0, 1)] == [
        Heads(0, 15, 0, 3), Heads(15, 10, 3, 2)]
    assert [head_split(40, 40, 16, r).n_q for r in range(16)] == \
        [3] * 8 + [2] * 8
    assert [head_split(32, 8, 16, r) for r in (0, 1, 2, 15)] == [
        Heads(0, 2, 0, 1, True), Heads(2, 2, 0, 1, True),
        Heads(4, 2, 1, 1, True), Heads(30, 2, 7, 1, True)]
    assert head_split(25, 5, 16, 0) is None          # gathered whole


# the recurrent mixers' and MLA's latent leaves: (parent, leaf) → what a
# rank holds under a split ("block": a block of its own; "sliced": whole,
# its gradient summed over the row; None: whole)
_MIXERS = {
    "hymba-1.5b": {("mamba", n): "block" for n in (
        "w_in", "conv", "w_bc", "w_dt", "dt_bias", "a_log", "d_skip",
        "w_out")},
    "xlstm-350m": {
        **{("mlstm", n): "block" for n in ("w_up", "w_v", "gn_scale",
                                           "w_down")},
        **{("mlstm", n): "sliced" for n in ("w_q", "w_k", "w_if", "b_if")},
        **{("slstm", n): "block" for n in ("w_x", "r", "b", "gn_scale")},
        ("slstm", "w_up"): None, ("slstm", "w_down"): None},   # 1365 wide
    "deepseek-v2-236b": {("attn", "w_dq"): "block",
                         ("attn", "w_dkv"): "block",
                         ("q_norm", "scale"): "sliced",
                         ("kv_norm", "scale"): "sliced"},
}
# leaves whose rank block is the JAX spec's model block (not moved; a
# per-layer vector is a matrix in the JAX layout, split by columns)
_JAX_BLOCK = {"conv", "w_dt", "dt_bias", "d_skip", "w_out", "w_v",
              "gn_scale", "w_down", "w_dq", "w_dkv"}


@pytest.mark.parametrize("M", MODEL_AXES)
@pytest.mark.parametrize("arch", list(_MIXERS))
def test_mixer_and_latent_leaves_split_by_channel(arch, M):
    """At full width on M model ranks: every Mamba leaf a block of the
    rank's inner channels; the mLSTM's ``w_v``/``gn_scale``/``w_down`` and
    the z half of ``w_up`` its value channels (the x half whole on every
    rank), ``w_q``/``w_k``/``w_if``/``b_if`` whole and summed; the sLSTM's
    cell its heads where M divides them (xlstm-350m's 4: M 2, 4), its FFN
    whole; MLA's ``w_dq``/``w_dkv`` column blocks, the norms summed.  The
    ranks' ranges tile each leaf's dim (the mLSTM's x half excepted), and
    the block is the JAX spec's model block exactly for the leaves the
    spec splits that way."""
    jcfg, cfg = jget(arch), get_config(arch)
    plan = js.make_plan(AbstractMesh((1, M), ("data", "model")), jcfg,
                        JMode.LOCAL, train=True)
    tp = TPPlan(M, full=True)
    slstm = cfg.family == "ssm" and cfg.ssm.mlstm_heads % M == 0
    seen = set()
    for p, leaf in jax.tree_util.tree_flatten_with_path(
            jreg.abstract_params(jcfg))[0]:
        key, shape = js._path_str(p), tuple(leaf.shape)
        parent, name = key.split("/")[-2:]
        want = _MIXERS[arch].get((parent, name), "none")
        if want == "none":
            continue
        seen.add((parent, name))
        if parent == "slstm" and not slstm:
            want = None
        blocks = [tp.leaf_block(key, shape, cfg, r) for r in range(M)]
        sliced = [tp.sliced_dim(key, shape, cfg, r) for r in range(M)]
        assert (blocks[0] is not None) == (want == "block"), key
        assert (sliced[0] is not None) == (want == "sliced"), key
        if want != "block":
            continue
        dim = blocks[0][0]
        got = sorted(rg for _, ranges in blocks for rg in ranges)
        if name == "w_up" and parent == "mlstm":     # x half on every rank
            di = shape[dim] // 2
            assert got[:M] == [(0, di)] * M
            got = got[M:]
        lo = 0 if not (name == "w_up" and parent == "mlstm") else di
        for a, b in got:
            assert a == lo, key                      # disjoint, in order
            lo = b
        assert lo == shape[dim], key                 # and covering
        spec = tuple(js._leaf_spec(key, jax.ShapeDtypeStruct(shape,
                                                             "float32"),
                                   plan, jcfg))
        n = shape[dim]
        jax_blocks = [(dim, ((r * n // M, (r + 1) * n // M),))
                      for r in range(M)]
        same = len(spec) > dim and spec[dim] == "model" \
            and blocks == jax_blocks
        assert same == (name in _JAX_BLOCK), (key, spec)
    assert seen == set(_MIXERS[arch])
