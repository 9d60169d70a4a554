"""The port's optimizer, synthetic data and loss against the JAX package
(CPU, reduced f32 configs, the JAX weights carried across by the bridge).

* AdamW, the schedule, the global norm and clipping against the JAX
  functions on the same trees, several steps, f32 and bf16 leaves, with
  and without decay, f32 and bf16 moments: ≤ 1e-6 relative (f32 math in
  both; the sums run in another order), bf16 leaves within one bf16
  rounding step;
* the decay rule: the port's ``decay_mask`` decays exactly the leaves the
  JAX package decays in its stacked layout, on every LM arch;
* the synthetic datasets: the same arrays bit for bit from the same seed;
* ``loss_fn`` against JAX's on every LM arch's reduced config, one forward
  each: loss, nll and aux ≤ 1e-5 relative (PERF.md §6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _train_oracle as orc
from repro.core.exchange import ExchangeConfig as JX
from repro.data import pipeline as jdata
from repro.models import registry as jreg
from repro.train import optimizer as jopt
from repro.train.train_step import loss_fn as jloss
from repro_torch.core.exchange import ExchangeConfig
from repro_torch.data import pipeline as tdata
from repro_torch.models.bridge import params_from_numpy
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import loss_fn
from repro_torch.utils.tree import tree_leaves

LOSS_TOL = 1e-5


def _trees(seed):
    """A matrix, a vector (no decay), a bf16 matrix and a scalar."""
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(6, 5).astype(np.float32),
            "b": rng.randn(5).astype(np.float32),
            "h": {"u": rng.randn(4, 3).astype(np.float32),
                  "s": np.float32(rng.randn())}}


def _grads(seed, scale=1.0):
    return jax.tree.map(lambda a: (a * scale).astype(np.float32),
                        _trees(seed + 100))


def _port(tree, bf16=()):
    return {k: (_port(v, bf16) if isinstance(v, dict) else
                torch.tensor(v, dtype=torch.bfloat16 if k in bf16
                             else torch.float32))
            for k, v in tree.items()}


def _ndim_mask(tree):
    """The JAX package's decay rule on a tree without layer stacks: a leaf
    decays where its ndim is at least 2."""
    return jax.tree.map(lambda a: np.ndim(a) >= 2, tree)


def _jax(tree, bf16=()):
    return {k: (_jax(v, bf16) if isinstance(v, dict) else
                jnp.asarray(v, jnp.bfloat16 if k in bf16 else jnp.float32))
            for k, v in tree.items()}


def _close(got, want, rtol, atol=0.0):
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(g, np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("step", [0, 1, 7, 10, 11, 55, 100, 250])
def test_schedule_matches_jax(step):
    cfg = dict(lr=2.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    got = topt.schedule(step, topt.OptConfig(**cfg))
    want = jopt.schedule(jnp.asarray(step), jopt.OptConfig(**cfg))
    _close(got, want, rtol=1e-6)


def test_global_norm_and_clip_match_jax():
    g = _grads(0, scale=1e3)
    _close(topt.global_norm(_port(g)), jopt.global_norm(_jax(g)), rtol=1e-6)
    p = _trees(1)
    _, _, tm = topt.adamw_update(_port(g), topt.adamw_init(_port(p)),
                                 _port(p), topt.OptConfig(clip_norm=1.0),
                                 _ndim_mask(p))
    _, _, jm = jopt.adamw_update(_jax(g), jopt.adamw_init(_jax(p)), _jax(p),
                                 jopt.OptConfig(clip_norm=1.0))
    _close(tm["grad_norm"], jm["grad_norm"], rtol=1e-6)
    _close(tm["lr"], jm["lr"], rtol=1e-6)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay", [0.0, 0.1])
def test_adamw_update_matches_jax(moments, decay):
    """Five steps from one state on the same gradients (clipping active on
    the first); f32 leaves ≤ 1e-6 relative, the bf16 leaf ``u`` within
    one bf16 rounding step of JAX's."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=20, weight_decay=decay)
    bf16 = ("u",)
    tp, jp = _port(_trees(2), bf16), _jax(_trees(2), bf16)
    ts = topt.adamw_init(tp, getattr(torch, moments))
    js = jopt.adamw_init(jp, getattr(jnp, moments))
    for step in range(5):
        g = _grads(step, scale=10.0 if step == 0 else 0.3)
        tp, ts, tm = topt.adamw_update(_port(g, bf16), ts, tp,
                                       topt.OptConfig(**cfg),
                                       _ndim_mask(_trees(2)))
        jp, js, jm = jopt.adamw_update(_jax(g, bf16), js, jp,
                                       jopt.OptConfig(**cfg))
        assert int(ts.step) == int(js.step) == step + 1
        _close(tm["grad_norm"], jm["grad_norm"], rtol=1e-6)
    for key, t, j in (("w", tp["w"], jp["w"]), ("b", tp["b"], jp["b"]),
                      ("s", tp["h"]["s"], jp["h"]["s"])):
        _close(t, j, rtol=1e-6, atol=1e-7)
    step = np.abs(np.asarray(jp["h"]["u"], np.float32)) * 2.0 ** -7
    assert (np.abs(tp["h"]["u"].float().numpy()
                   - np.asarray(jp["h"]["u"], np.float32)) <= step).all()
    assert ts.m["w"].dtype == getattr(torch, moments)
    for t, j in ((ts.m["w"], js.m["w"]), (ts.v["b"], js.v["b"])):
        _close(t, j, rtol=1e-6 if moments == "float32" else 2 ** -7)


def test_adamw_decreases_quadratic():
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = topt.adamw_init(params)
    cfg = topt.OptConfig(lr=0.1, warmup_steps=0, weight_decay=0.0)
    for _ in range(60):
        params, opt, _ = topt.adamw_update({"w": 2 * params["w"]}, opt,
                                           params, cfg, {"w": False})
    assert float(params["w"].abs().max()) < 0.4


@pytest.mark.parametrize("arch", orc.LM_ARCHS)
def test_decay_mask_follows_the_jax_layout(arch):
    """The JAX package decays a leaf of ndim ≥ 2 in its stacked layout:
    every per-layer leaf (norm scales included) and the top-level
    matrices.  Carried across by the bridge, the port's mask decays the
    same elements (a 1-D per-layer norm scale decays; ``final_norm`` and
    the vlm's scalar ``gate``, stacked to 1-D there, do not)."""
    jcfg, cfg = orc.configs(arch)
    jp = jax.eval_shape(lambda: jreg.init_params(jcfg, seed=0))
    marks = jax.tree.map(lambda s: np.full(s.shape, float(len(s.shape) >= 2),
                                           np.float32), jp)
    port_marks = params_from_numpy(marks, cfg)
    _, params = orc.weights(jcfg, cfg)
    mask = topt.decay_mask(params, cfg)
    got, want = tree_leaves(mask), tree_leaves(port_marks)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (w == float(g)).all()
    if any(v.ndim == 1 for v in tree_leaves(params["final_norm"])):
        assert not any(tree_leaves(mask["final_norm"]))


def test_lm_dataset_is_bit_identical():
    for seed in (0, 3):
        j = jdata.SyntheticLMDataset(97, 33, 5, seed=seed)
        t = tdata.SyntheticLMDataset(97, 33, 5, seed=seed)
        np.testing.assert_array_equal(j._succ, t._succ)
        for _, (a, b) in zip(range(3), zip(j.batches(), t.batches())):
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        a = j.sample(np.random.RandomState(11))
        b = t.sample(np.random.RandomState(11))
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    a, b = jdata.make_lm_batch(64, 3, 9, 5), tdata.make_lm_batch(64, 3, 9, 5)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_image_data_is_bit_identical():
    for (ja, jl), (ta, tl) in ((jdata.synthetic_vit_task(2, 4),
                                tdata.synthetic_vit_task(2, 4)),):
        np.testing.assert_array_equal(ja, ta)
        np.testing.assert_array_equal(jl, tl)
    jit, tit = (m.SyntheticImageDataset(batch_size=2, seed=1).batches()
                for m in (jdata, tdata))
    for _ in range(2):
        (ja, jl), (ta, tl) = next(jit), next(tit)
        np.testing.assert_array_equal(ja, ta)
        np.testing.assert_array_equal(jl, tl)


def test_prefetcher_yields_the_stream_in_order():
    ds = tdata.SyntheticLMDataset(50, 8, 2, seed=4)
    it = ds.batches()
    want = [next(it) for _ in range(4)]
    pf = tdata.Prefetcher(ds.batches(), depth=2)
    for w in want:
        np.testing.assert_array_equal(next(pf)["tokens"], w["tokens"])
    assert list(tdata.Prefetcher(iter([1, 2, 3]))) == [1, 2, 3]


@pytest.mark.parametrize("arch", orc.LM_ARCHS)
def test_loss_fn_matches_jax(arch):
    over = {"window": 4} if arch == "gemma2-27b" else {}
    jcfg, cfg = orc.configs(arch, **over)
    jp, tp = orc.weights(jcfg, cfg)
    if cfg.family == "vlm":            # the gates at 0 erase the memory
        jp = dict(jp, cross_layers=dict(jp["cross_layers"],
                                        gate=jp["cross_layers"]["gate"] + 0.5))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg)
    b = orc.batch(cfg, 2, 16, seed=1)
    jl, jparts = jloss(jp, orc.to_jax(b), jcfg, JX())
    with torch.no_grad():
        tl, tparts = loss_fn(tp, orc.to_torch(b), cfg, ExchangeConfig())
    _close(tl, jl, rtol=LOSS_TOL)
    _close(tparts["nll"], jparts["nll"], rtol=LOSS_TOL)
    _close(tparts["aux"], jparts["aux"], rtol=LOSS_TOL, atol=1e-7)
    if cfg.family == "moe":
        assert float(tparts["aux"]) > 0


def test_loss_fn_refuses_a_vit():
    from repro_torch.configs import get_config
    with pytest.raises(ValueError, match="ViT"):
        loss_fn({}, {}, get_config("vit-base-16"), ExchangeConfig())


def test_opt_config_defaults_match_jax():
    assert dataclasses.asdict(topt.OptConfig()) == dataclasses.asdict(
        jopt.OptConfig())


def test_eval_step_matches_jax():
    from repro.train.train_step import build_eval_step as jeval
    from repro_torch.train.train_step import build_eval_step
    jcfg, cfg = orc.configs("llama3.2-1b")
    jp, tp = orc.weights(jcfg, cfg)
    b = orc.batch(cfg, 2, 16, seed=3)
    want = jeval(jcfg, JX())(jp, orc.to_jax(b))
    got = build_eval_step(cfg, ExchangeConfig())(tp, orc.to_torch(b))
    assert set(got) == set(want) == {"loss", "nll", "aux"}
    for k in want:
        _close(got[k], want[k], rtol=LOSS_TOL, atol=1e-7)
    assert not got["loss"].requires_grad
