"""Checkpoints, the fault-tolerant loop, elastic membership and gradient
compression in the port (CPU).

* The JAX package's checkpoint tests re-run on the port (round trip,
  rotation, async, restore-or-none, missing leaf, atomic publish), and a
  checkpoint written by either package loads in the other, bit for bit,
  for one tree of dicts, lists, tuples and an AdamW state, bf16 included.
* ``FaultTolerantLoop``: a run with an injected failure resumes from its
  checkpoint and ends on the state of an uninterrupted run, in the port
  alone (the JAX package's replay test is intermittent, ROADMAP §3); the
  ``Trainer`` likewise ends on params bit-identical to an uninterrupted
  run.
* ``largest_mesh_shape`` and ``ElasticMeshManager.drop`` against the JAX
  functions; the mesh a drop rebuilds.
* ``compress``, ``decompress``, error feedback and the ratio against the
  JAX functions (≤ 1e-6 relative; the means are f32 sums in another
  order).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.runtime import elastic as jel
from repro.train import grad_compress as jgc
from repro.train import optimizer as jopt
from repro_torch.checkpoint.manager import (CheckpointManager, latest_step,
                                            load_pytree, save_pytree)
from repro_torch.runtime import elastic as tel
from repro_torch.runtime.fault import FaultTolerantLoop, HeartbeatMonitor
from repro_torch.train import grad_compress as tgc
from repro_torch.train import optimizer as topt
from repro_torch.utils.tree import tree_leaves, tree_map


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"layer": {"w": torch.from_numpy(rng.randn(4, 8).astype(np.float32)),
                      "b": torch.from_numpy(rng.randn(8).astype(np.float32))
                      .to(torch.bfloat16)},
            "step": torch.tensor(3, dtype=torch.int32)}


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save_pytree(t, str(tmp_path), step=7)
    restored = load_pytree(tree_map(torch.zeros_like, t), str(tmp_path))
    for a, b in zip(tree_leaves(t), tree_leaves(restored)):
        _same(a, b)


def test_latest_step_and_rotation(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        mgr.save(_tree(s), s)
    assert mgr.latest == 30 == latest_step(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["step_00000020", "step_00000030"]


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    src = _tree(1)
    mgr.save_async(src, 5)
    src["layer"]["w"].add_(1.0)        # the host copy was taken at the call
    mgr.wait()
    assert mgr.latest == 5
    restored = mgr.restore(_tree(99))
    _same(restored["layer"]["w"], _tree(1)["layer"]["w"])


def test_restore_or_none_empty(tmp_path):
    assert CheckpointManager(str(tmp_path)).restore_or_none(_tree()) is None


def test_missing_leaf_raises(tmp_path):
    save_pytree({"a": torch.zeros(3)}, str(tmp_path), step=1)
    with pytest.raises(KeyError):
        load_pytree({"a": torch.zeros(3), "b": torch.zeros(2)}, str(tmp_path))


def test_atomicity_no_partial_dirs(tmp_path):
    save_pytree(_tree(), str(tmp_path), step=2)
    assert all("tmp" not in d for d in os.listdir(tmp_path))


def _cross_trees(seed):
    """The same tree in both packages: dicts, a list, a tuple, f32, bf16
    and int32 leaves, and an AdamW state (a NamedTuple)."""
    rng = np.random.RandomState(seed)
    a = rng.randn(3, 5).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    c = rng.randint(-9, 9, (2, 2)).astype(np.int32)
    j = ({"w": jnp.asarray(a), "seq": [jnp.asarray(b, jnp.bfloat16),
                                       (jnp.asarray(c),)]},
         jopt.adamw_init({"w": jnp.asarray(a)}))
    t = ({"w": torch.from_numpy(a),
          "seq": [torch.from_numpy(b).to(torch.bfloat16),
                  (torch.from_numpy(c),)]},
         topt.adamw_init({"w": torch.from_numpy(a)}))
    return j, t


def _np_leaves(tree, jax_side):
    if jax_side:
        return [np.asarray(x, np.float32) for x in
                jax.tree_util.tree_leaves(tree)]
    return [x.float().numpy() for x in tree_leaves(tree)]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_load_across_the_packages(tmp_path, writer):
    j, t = _cross_trees(0)
    jz, tz = _cross_trees(1)          # templates holding other values
    if writer == "jax":
        jckpt.save_pytree(j, str(tmp_path), step=4, process_index=0)
        got = load_pytree(tz, str(tmp_path))
        want = t
        assert [x.dtype for x in tree_leaves(got)] == \
            [x.dtype for x in tree_leaves(t)]
        for a, b in zip(_np_leaves(got, False), _np_leaves(want, False)):
            np.testing.assert_array_equal(a, b)
    else:
        save_pytree(t, str(tmp_path), step=4)
        got = jckpt.load_pytree(jz, str(tmp_path))
        assert [x.dtype for x in jax.tree_util.tree_leaves(got)] == \
            [x.dtype for x in jax.tree_util.tree_leaves(j)]
        for a, b in zip(_np_leaves(got, True), _np_leaves(j, True)):
            np.testing.assert_array_equal(a, b)


def _counter_loop(path, ckpt_every=2):
    """step_fn: state = (count, checksum); the checksum folds the batch in,
    so a divergent replay would change it."""
    def step_fn(state, batch):
        c, h = state
        return (c + 1, h * 31 + batch), {}

    def batch_fn(step):
        return torch.tensor(step * step + 7, dtype=torch.int64)

    ckpt = CheckpointManager(str(path), keep=3)
    mon = HeartbeatMonitor(["n0", "n1"], timeout_s=1e9)
    return FaultTolerantLoop(step_fn, batch_fn, ckpt, mon,
                             ckpt_every=ckpt_every), ckpt


def _start():
    return (torch.tensor(0, dtype=torch.int64),
            torch.tensor(1, dtype=torch.int64))


def test_restart_replays_to_the_uninterrupted_state(tmp_path):
    loop, _ = _counter_loop(tmp_path / "a")
    clean, step = loop.run(_start(), 0, 10)
    loop2, _ = _counter_loop(tmp_path / "b")
    failed, step2 = loop2.run(_start(), 0, 10, fail_at={5: "n1"})
    kinds = [e.kind for e in loop2.events]
    assert kinds == ["node_down", "restart"]
    assert loop2.events[1].step == 4          # the newest checkpoint
    assert step == step2 == 10
    assert int(clean[0]) == int(failed[0]) == 10
    assert int(clean[1]) == int(failed[1])


def test_resume_from_existing_checkpoint(tmp_path):
    loop, ckpt = _counter_loop(tmp_path)
    _, step = loop.run(_start(), 0, 6)
    assert step == 6
    loop2 = FaultTolerantLoop(loop.step_fn, loop.batch_fn, ckpt,
                              HeartbeatMonitor(["n0"]), ckpt_every=2)
    _, step2 = loop2.run(_start(), 0, 8)
    assert any(e.kind == "restart" for e in loop2.events)
    assert step2 == 8


def test_trainer_resumes_to_bit_identical_params(tmp_path):
    """A reduced f32 llama trained 6 steps with a checkpoint every 2 and a
    failure injected at step 3 (restored from step 2, steps 2–5 replayed
    from the data cursor) ends on the params and moments of the run
    without a failure, bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.core.exchange import ExchangeConfig
    from repro_torch.train.loop import Trainer, TrainerConfig
    cfg = get_config("llama3.2-1b").reduced(dtype="float32", vocab_size=64)
    opt = topt.OptConfig(lr=1e-3, warmup_steps=1)
    runs = []
    for name, fail in (("clean", None), ("failed", {3: "host0"})):
        tc = TrainerConfig(steps=6, ckpt_every=2, batch_size=2, seq_len=16,
                           ckpt_dir=str(tmp_path / name))
        tr = Trainer(cfg, ExchangeConfig(), tc, opt, device="cpu")
        assert tr.run(fail_at=fail) == 6
        runs.append(tr)
    clean, failed = runs
    assert [e.kind for e in failed.loop.events] == ["node_down", "restart"]
    assert len(failed.metrics_log) == 7      # step 2 ran twice
    for a, b in zip(tree_leaves((clean.params, clean.opt_state)),
                    tree_leaves((failed.params, failed.opt_state))):
        assert torch.equal(a, b)
    assert clean.metrics_log[-1]["loss"] < clean.metrics_log[0]["loss"]


def test_trainer_on_the_card_needs_one(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.core.exchange import ExchangeConfig
    from repro_torch.train.loop import Trainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(get_config("llama3.2-1b").reduced(), ExchangeConfig())


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 15, 16, 17, 31, 33, 100, 513])
def test_largest_mesh_shape_matches_jax(n):
    assert tel.largest_mesh_shape(n) == jel.largest_mesh_shape(n)


def test_elastic_drop_matches_jax():
    class Dev:
        def __init__(self, i):
            self.id = i

    for failed in (["d1"], ["d3", "d0"], 1, 0, 4):
        j = jel.ElasticMeshManager(cfg=None, mode=None,
                                   devices=["d0", "d1", "d2", "d3"])
        t = tel.ElasticMeshManager(cfg=None, mode=None,
                                   devices=["d0", "d1", "d2", "d3"])
        j.drop(failed, rebuild=False)
        assert t.drop(failed, rebuild=False) is None
        assert t.devices == j.devices
    devs = [Dev(i) for i in range(4)]
    t = tel.ElasticMeshManager(cfg=None, mode=None, devices=list(devs))
    t.drop([0], rebuild=False)                    # matched by .id
    assert t.devices == devs[1:]
    for bad, match in ((["nope"], "not in the healthy"), (7, "cannot drop"),
                       (np.int64(-1), "cannot drop")):
        with pytest.raises(ValueError, match=match):
            t.drop(bad, rebuild=False)


def test_elastic_mesh_building_is_not_ported():
    """Building the mesh and its plan, once not ported, now runs: the
    survivors of a drop form the largest viable (data, model) grid of
    their rank ids, planned as the JAX package plans it
    (``tests/test_torch_sharding.py`` holds every field to JAX's)."""
    from repro_torch.configs import get_config
    from repro_torch.core.exchange import ExchangeMode
    cfg = get_config("llama3.2-1b")
    t = tel.ElasticMeshManager(cfg=cfg, mode=ExchangeMode.PRISM, L=4,
                               devices=[0, 1, 2, 3])
    mesh, plan = t.drop([2, 3])
    assert dict(mesh.shape) == {"data": 1, "model": 2}
    assert mesh.devices.tolist() == [[0, 1]]
    assert plan.xcfg.seq_shards == 2 and plan.xcfg.seq_axis == "model"
    mesh, plan = t.build((1, 1), ("data", "model"))
    assert mesh.devices.tolist() == [[0]] and plan.L == 4
    mesh, _ = tel.replan_for_failure(cfg, ExchangeMode.PRISM, 12)
    assert dict(mesh.shape) == {"data": 3, "model": 4}


@pytest.mark.parametrize("rows,L", [(8, 4), (8, 8), (8, 3), (12, 2),
                                    (5, 1)])
def test_grad_compress_matches_jax(rows, L):
    rng = np.random.RandomState(rows * 10 + L)
    g = rng.randn(rows, 3).astype(np.float32)
    res = rng.randn(rows, 3).astype(np.float32)
    tg, jg = torch.from_numpy(g), jnp.asarray(g)
    z = tgc.compress(tg, L)
    np.testing.assert_allclose(z.numpy(), np.asarray(jgc.compress(jg, L)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tgc.decompress(z, rows).numpy(),
                                  np.asarray(jgc.decompress(jnp.asarray(
                                      z.numpy()), rows)))
    tz, tr = tgc.compress_with_feedback(tg, torch.from_numpy(res), L)
    jz, jr = jgc.compress_with_feedback(jg, jnp.asarray(res), L)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6,
                               atol=1e-6)
    assert tgc.compression_ratio(rows, L) == jgc.compression_ratio(rows, L)


def test_error_feedback_telescopes():
    """Σ over steps of the transmitted (decompressed) payloads plus the
    final residual equals Σ of the gradients, exactly up to f32 rounding."""
    rng = np.random.RandomState(5)
    res, sent, total = None, torch.zeros(16, 4), torch.zeros(16, 4)
    for _ in range(6):
        g = torch.from_numpy(rng.randn(16, 4).astype(np.float32))
        z, res = tgc.compress_with_feedback(g, res, 4)
        sent += tgc.decompress(z, 16)
        total += g
    np.testing.assert_allclose((sent + res).numpy(), total.numpy(),
                               atol=1e-5)
    zeros = tgc.init_residuals({"a": torch.ones(2, 3)})
    assert zeros["a"].dtype == torch.float32 and not zeros["a"].any()
