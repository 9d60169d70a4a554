"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's and against the port's own real collectives (CPU):

* the pure functions (``default_mode``, ``model_flops``,
  ``active_params``, ``grad_accum_for``) equal the JAX package's on every
  arch × shape;
* the abstract collectives (``core.seq_group.AbstractSeqGroup``) book the
  same ``GatherStats`` (bytes by kind, ``calls``, ``halo_calls``,
  ``state_calls``), call by call in the same order, as the real gloo ones
  on every rank: one (2, 2) spawn of a reduced llama ``prism`` mesh train
  step, its ``local`` TP step, reduced deepseek-moe, deepseek-v2 (MLA by
  heads and latent columns), hymba at 5/5 heads (3 + 2, the moved
  leaves' gathers and reduce-scatters; its Mamba by channel) and xLSTM
  (mLSTM by value channel, sLSTM by head) ``local`` TP steps, xLSTM's
  ``local`` TP decode step and ``build_decode_step`` under ``prism``; and
  a seq group of 2 ranks'
  ``voltage`` and ``prism`` forwards and hymba's state hand-off
  (``pass_on``) forward and gradient;
* a rank's param and optimizer bytes on (16, 16) and (2, 16, 16), for
  every arch and mode, equal each leaf's bytes divided by the mesh axes of
  its JAX spec (``repro.sharding.specs`` on abstract meshes);
* the ``("pod", "data", "model")`` mesh: a (2, 1, 2) ``prism`` gradient
  and AdamW step against ``jax.value_and_grad``/``build_train_step`` on
  the whole batch (PERF.md §6's tolerances), and
  ``build_train_step(acc_dtype=bfloat16, grad_accum=2)`` against the JAX
  step with the same ``acc_dtype``;
* the command line at full width ends ``ALL DRY-RUN CELLS PASSED`` and
  writes its record.

The spawns start in the background at the first test that needs them and
run while JAX computes its references.
"""
import json
import os
import subprocess
import sys
import threading
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import _torch_ranks
import _train_oracle as orc
from _exchange_oracle import prism_oracle
from repro.configs import get_config as jget
from repro.configs import shapes_for as jshapes_for
from repro.core import exchange as jx
from repro.core.exchange import ExchangeMode as JMode
from repro.models import registry as jreg
from repro.sharding import specs as js
from repro.train.optimizer import OptConfig as JOpt
from repro.train.optimizer import adamw_init as jinit
from repro.train.train_step import build_train_step as jbuild
from repro.train.train_step import loss_fn as jloss
from repro.utils.tree import param_count as jcount
from repro_torch.configs import ASSIGNED_ARCHS, get_config, shapes_for
from repro_torch.core.exchange import ExchangeConfig
from repro_torch.core.exchange import ExchangeMode as TMode
from repro_torch.core.seq_group import (AbstractSeqGroup, register_seq_group,
                                        spawn, spawn_mesh,
                                        unregister_seq_group)
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import StepCounter, storage_bytes
from repro_torch.launch.mesh import (join_abstract, leave_mesh,
                                     make_auto_mesh)
from repro_torch.models import registry
from repro_torch.sharding.specs import make_plan
from repro_torch.train.optimizer import OptConfig, adamw_init
from repro_torch.train.train_step import build_train_step
from repro_torch.utils.tree import param_count

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("data", "model")
META = torch.device("meta")
LR = 1e-3


def _jax_dryrun():
    """``repro.launch.dryrun``, imported with the backend up first and
    ``XLA_FLAGS`` restored after: the module sets 512 host devices at
    import, which must reach neither this process nor a subprocess."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jd
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jd


# --- (b) the pure functions ------------------------------------------------

@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_pure_functions_match_jax(arch):
    jd = _jax_dryrun()
    jcfg, cfg = jget(arch), get_config(arch)
    n = param_count(registry.abstract_params(cfg))
    assert n == jcount(jreg.abstract_params(jcfg))
    assert dryrun.grad_accum_for(cfg) == jd.grad_accum_for(jcfg)
    assert dryrun.active_params(cfg, n) == jd.active_params(jcfg, n)
    assert [s.name for s in shapes_for(arch)] == \
        [s.name for s in jshapes_for(arch)]
    for shape, jshape in zip(shapes_for(arch), jshapes_for(arch)):
        assert dryrun.default_mode(cfg, shape.kind).value == \
            jd.default_mode(jcfg, jshape.kind).value
        assert dryrun.model_flops(cfg, shape, n) == \
            jd.model_flops(jcfg, jshape, n)
    assert dryrun.DEFAULT_L == jd.DEFAULT_L


# --- (c) the abstract collectives against the real ones -------------------

MESH_CASES = {
    "llama prism train": dict(arch="llama3.2-1b", kind="train",
                              mode="prism", B=4, N=16, L=4),
    "llama local TP train": dict(arch="llama3.2-1b", kind="train",
                                 mode="local", B=4, N=16, L=4),
    "moe local TP train": dict(arch="deepseek-moe-16b", kind="train",
                               mode="local", B=4, N=16, L=4),
    "mla local TP train": dict(arch="deepseek-v2-236b", kind="train",
                               mode="local", B=4, N=16, L=4),
    "hymba uneven local TP train": dict(
        arch="hymba-1.5b", kind="train", mode="local", B=4, N=16, L=4,
        over=dict(n_heads=5, n_kv_heads=5, d_model=80)),
    "xlstm local TP train": dict(arch="xlstm-350m", kind="train",
                                 mode="local", B=4, N=16, L=4),
    "xlstm local TP decode": dict(arch="xlstm-350m", kind="decode",
                                  mode="local", B=4, N=16, L=4),
    "llama prism decode": dict(arch="llama3.2-1b", kind="decode",
                               mode="prism", B=4, N=16, L=4),
}
SEQ_CASES = {
    "llama voltage": dict(arch="llama3.2-1b", mode="voltage", B=2, N=16,
                          L=4),
    "llama prism": dict(arch="llama3.2-1b", mode="prism", B=2, N=16, L=4),
    "hymba prism": dict(arch="hymba-1.5b", mode="prism", B=2, N=16, L=4),
    "hymba prism grad": dict(arch="hymba-1.5b", mode="prism", B=2, N=16,
                             L=4, grad=True),
}
_RUNS = {}


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


def _start():
    if _RUNS:
        return
    pod = _pod_job()

    def mesh():
        _RUNS["mesh"] = spawn_mesh(_torch_ranks.dryrun_mesh, (2, 2), NAMES,
                                   {"cases": MESH_CASES}, timeout=300)
        _RUNS["pod"] = spawn_mesh(
            _torch_ranks.mesh_train, (2, 1, 2), ("pod", "data", "model"),
            pod, timeout=300)

    def seq():
        _RUNS["seq"] = spawn(_torch_ranks.dryrun_seq, 2,
                             {"cases": SEQ_CASES}, timeout=300)

    _RUNS["threads"] = [_Runner(mesh), _Runner(seq)]


def _runs(key):
    _start()
    for t in _RUNS["threads"]:
        if key not in _RUNS:
            t.join()
            if t.error is not None:
                raise t.error
    return _RUNS[key]


@pytest.mark.parametrize("label", list(MESH_CASES))
def test_abstract_mesh_collectives_match_real(label):
    _start()
    c = MESH_CASES[label]
    cfg = _torch_ranks.dry_cfg(c)
    mesh = make_auto_mesh((2, 2), NAMES)
    want = {}
    for coords in ({"data": d, "model": m} for d in (0, 1) for m in (0, 1)):
        with _torch_ranks.logged_calls() as log:
            got = dryrun.trace_step(cfg, c["kind"], mesh,
                                    mode=TMode(c["mode"]), B=c["B"],
                                    N=c["N"], L=c["L"], coords=coords)
        want[tuple(coords.values())] = (got["gather"]["by_axis"], log)
    for r in _runs("mesh"):
        stats, log = want[tuple(r["coords"].values())]
        assert r[label]["stats"] == stats, (label, r["coords"])
        assert r[label]["log"] == log, (label, r["coords"])
        assert sum(s["calls"] for s in stats.values()) > 0


def _abstract_seq(c, rank):
    cfg = _torch_ranks.dry_cfg(c)
    group = register_seq_group(AbstractSeqGroup("seq", rank, 2))
    try:
        params = registry.abstract_params(cfg)
        tokens = torch.empty((c["B"], c["N"]), dtype=torch.int32,
                             device=META)
        with _torch_ranks.logged_calls() as log, StepCounter():
            _torch_ranks.seq_case(c, params, {"tokens": tokens,
                                              "labels": tokens})
        return _torch_ranks.stats_of([group]), log
    finally:
        unregister_seq_group("seq")


@pytest.mark.parametrize("label", list(SEQ_CASES))
def test_abstract_seq_collectives_match_real(label):
    _start()
    want = [_abstract_seq(SEQ_CASES[label], rank) for rank in (0, 1)]
    for rank, r in enumerate(_runs("seq")):
        stats, log = want[rank]
        assert r[label]["stats"] == stats, (label, rank)
        assert r[label]["log"] == log, (label, rank)
    if label.startswith("hymba"):             # the hand-off ran, booked
        assert want[0][0]["seq"]["state_calls"] > 0
        assert want[1][0]["seq"]["state_bytes"] > 0


# --- (d) a rank's param and optimizer bytes --------------------------------

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _jax_bytes(shardings, leaves, mesh, itemsize=None):
    """Σ over leaves of the leaf's bytes / the mesh axes its spec shards
    it over."""
    specs = {js._path_str(p): s.spec for p, s in
             jax.tree_util.tree_flatten_with_path(shardings)[0]}
    total = 0
    for p, leaf in jax.tree_util.tree_flatten_with_path(leaves)[0]:
        div = 1
        for e in specs[js._path_str(p)]:
            for a in (() if e is None else e if isinstance(e, tuple)
                      else (e,)):
                div *= mesh.shape[a]
        n = int(np.prod(leaf.shape))
        assert n % div == 0
        total += n // div * (itemsize or leaf.dtype.itemsize)
    return total


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_rank_state_bytes_match_jax_specs(arch, mesh_id):
    shape, names = MESHES[mesh_id]
    jcfg, cfg = jget(arch), get_config(arch)
    jparams = jreg.abstract_params(jcfg)
    aparams = registry.abstract_params(cfg)
    jmesh = AbstractMesh(shape, names)
    mdt = torch.bfloat16 if dryrun._param_gb(cfg) > 100 else torch.float32
    for mode in ("local", "prism", "voltage"):
        jp = js.make_plan(jmesh, jcfg, JMode(mode), L=16, train=True)
        mesh = make_auto_mesh(shape, names)
        plan = make_plan(mesh, cfg, TMode(mode), L=16, train=True)
        join_abstract(mesh)
        try:
            _, blocks, opt = dryrun.train_state(plan, cfg, aparams, mdt)
        finally:
            leave_mesh()
        assert storage_bytes(blocks) == _jax_bytes(
            js.param_shardings(jp, jcfg, jparams), jparams, jmesh), mode
        assert storage_bytes(opt.m, opt.v) == 2 * _jax_bytes(
            js.opt_state_shardings(jp, jcfg, jparams), jparams, jmesh,
            mdt.itemsize), mode


# --- (e) the ("pod", "data", "model") mesh, and acc_dtype ----------------

POD_B, POD_N, POD_L = 4, 16, 4


def _side():
    jcfg, cfg = orc.configs("llama3.2-1b")
    jp, tp = orc.weights(jcfg, cfg)
    return jcfg, cfg, jp, tp


def _pod_job():
    jcfg, cfg, jp, _ = _side()
    return dict(arch="llama3.2-1b", reduced={"dtype": "float32"}, L=POD_L,
                params=jax.tree.map(np.asarray, jp), modes=("prism",),
                batch=orc.batch(cfg, POD_B, POD_N, seed=1))


def _keyed(tree):
    return {js._path_str(p): np.asarray(leaf, np.float32) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_pod_mesh_prism_step_matches_jax():
    """(2, 1, 2) ``("pod", "data", "model")``: the batch over ``("pod",
    "data")``, the sequence over ``model``; the loss within 1e-5 and the
    gradient within 2e-5 of each leaf's largest value of
    ``jax.value_and_grad`` on the whole batch; AdamW's metrics within
    1e-5 and its params by ``check_step``'s line."""
    _start()
    jcfg, cfg, jp, _ = _side()
    b = orc.to_jax(orc.batch(cfg, POD_B, POD_N, seed=1))
    jxc = jx.ExchangeConfig(JMode.PRISM, seq_axis="seq", seq_shards=2,
                            L=POD_L)
    with mock.patch.object(jx, "prism_prefill_attention", prism_oracle):
        (loss, _), g = jax.jit(jax.value_and_grad(
            lambda p: jloss(p, b, jcfg, jxc), has_aux=True))(jp)
        new, _, m = jax.jit(jbuild(jcfg, jxc, JOpt(
            lr=LR, warmup_steps=1)))(jp, jinit(jp), b)
    want, want_new = _keyed(g), _keyed(new)
    runs = _runs("pod")
    for r in runs:
        np.testing.assert_allclose(r["prism"]["loss"], float(loss),
                                   rtol=1e-5)
        assert r["prism"]["grad_digest"] == runs[0]["prism"]["grad_digest"]
        assert r["prism"]["param_digest"] == \
            runs[0]["prism"]["param_digest"]
    got = runs[0]["prism"]
    assert got["grads"].keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        assert float(np.abs(got["grads"][k] - want[k]).max()) <= \
            2e-5 * scale, k
    for k in ("loss", "nll", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(got["metrics"][k], float(m[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    sure = 0
    for k, w in want_new.items():
        dg = np.abs(got["grads"][k] - want[k]).max()
        ok = (np.abs(want[k]) > 100.0 * dg) | ((want[k] == 0)
                                               & (got["grads"][k] == 0))
        diff = np.abs(got["params"][k] - w)
        assert (diff[ok] <= 1e-6).all(), k
        assert (diff <= 2 * LR + 1e-6).all(), k
        sure += int(ok.sum())
    assert sure >= 0.9 * sum(w.size for w in want_new.values())
    assert got["booked_step"].keys() == {"pod", "data", "model"}


BF16_STEP = 2.0 ** -7     # two bf16 roundings (8 significant bits each)


def test_bf16_accumulator_matches_jax():
    """``build_train_step(acc_dtype=bfloat16, grad_accum=2)`` against the
    JAX step with the same ``acc_dtype``.  Each microbatch's f32 gradient
    g₁, g₂ agrees within 2e-5 of its leaf's largest; both steps round it
    to bf16, sum in bf16 and halve, so the accumulated gradient may differ
    by a bf16 rounding of each addend and of the sum: 2⁻⁷ · (|g₁| + |g₂|)
    / 2 (a sum that cancels keeps its addends' rounding).  Compared in the
    first moment, 0.1 · clip · (g₁ + g₂) / 2; the loss within 1e-5, the
    norm within 2⁻⁷."""
    from repro_torch.train.train_step import _grads_of
    from repro_torch.utils.tree import tree_unflatten_like
    jcfg, cfg, jp, tp = _side()
    b = orc.batch(cfg, 4, 16, seed=2)
    _, js_, jm = jax.jit(jbuild(jcfg, jx.ExchangeConfig(), JOpt(
        lr=LR, warmup_steps=1), grad_accum=2, acc_dtype=jnp.bfloat16))(
            jp, jinit(jp), orc.to_jax(b))
    opt = OptConfig(lr=LR, warmup_steps=1)
    step = build_train_step(cfg, ExchangeConfig(), opt, grad_accum=2,
                            acc_dtype=torch.bfloat16)
    _, ts_, tm = step(tp, adamw_init(tp), orc.to_torch(b))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=BF16_STEP)
    clip = min(1.0, opt.clip_norm / (float(tm["grad_norm"]) + 1e-9))
    addends = [orc.flat(orc.jax_layout(jp, tree_unflatten_like(
        tp, _grads_of(tp, orc.to_torch(mb), cfg, ExchangeConfig())[2])))
        for mb in orc._split(b, 2)]
    want = orc.flat(orc.jax_layout(jp, js_.m))
    got = orc.flat(orc.jax_layout(jp, ts_.m))
    assert got.keys() == want.keys()
    for k, w in want.items():
        spread = 0.1 * clip * (np.abs(addends[0][k])
                               + np.abs(addends[1][k])) / 2
        err = np.abs(got[k] - w)
        assert (err <= BF16_STEP * spread
                + 2e-5 * float(np.abs(w).max())).all(), k
    _, f32, _ = build_train_step(cfg, ExchangeConfig(), opt,
                                 grad_accum=2)(tp, adamw_init(tp),
                                               orc.to_torch(b))
    f32 = orc.flat(orc.jax_layout(jp, f32.m))
    assert any((f32[k] != got[k]).any() for k in got)   # bf16 took effect


# --- (f) the command line -------------------------------------------------

def test_cli_full_width_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3.2-1b", "--shape", "train_4k", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.rstrip().endswith("ALL DRY-RUN CELLS PASSED")
    with open(tmp_path / "16x16" / "llama3.2-1b__train_4k__prism.json") as f:
        rec = json.load(f)
    for key in ("n_params", "param_bytes", "memory", "roofline",
                "model_flops_global", "model_flops_per_device",
                "useful_flops_ratio", "gather_stats", "trace_s"):
        assert key in rec, key
    mem = rec["memory"]
    for key in ("argument_bytes", "output_bytes", "temp_bytes",
                "peak_bytes", "per_device_total_bytes", "fits_80gb"):
        assert key in mem, key
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert rec["n_params"] == 1235814400 and rec["n_chips"] == 256
    roof = rec["roofline"]
    assert roof["per_device_flops"] > rec["model_flops_per_device"] > 0
    assert rec["gather_stats"]["grad_bytes"] > 0
