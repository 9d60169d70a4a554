"""The port's sharding plans against the JAX package's (CPU, no devices):
``repro_torch.sharding.specs`` against ``repro.sharding.specs`` on
``jax.sharding.AbstractMesh`` meshes, leaf for leaf, in the JAX layout.

* every arch of ``ASSIGNED_ARCHS`` and the ViT, at their published
  widths (the params on the meta device: ``registry.abstract_params``);
* ``local`` / ``prism`` / ``voltage`` × train / inference / decode;
* the params' specs, the optimizer state's, ``batch_shardings``' (a
  divisible and an odd batch) and ``cache_shardings``' (the decode cache,
  ``registry.abstract_cache``);
* the meshes (16, 16), (2, 16, 16), (4, 2), (2, 2) and (3, 1);
* ``make_plan``'s fields and ``xcfg``; ``ElasticMeshManager.build`` /
  ``best_mesh`` / ``drop`` and ``replan_for_failure`` for 1–32 members
  (the JAX side's ``Mesh`` made abstract, its ``jax.devices`` a list of
  ids: a CPU host has one JAX device);
* the ``Placement`` blocks: every rank's blocks of a leaf tile it once,
  and the optimizer's blocks refine the params'.
"""
import itertools
from unittest import mock

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as jget
from repro.configs.base import ShapeSpec as JShape
from repro.core.exchange import ExchangeMode as JMode
from repro.models import registry as jreg
from repro.runtime import elastic as jel
from repro.sharding import specs as js
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.exchange import ExchangeMode
from repro_torch.launch.mesh import (make_auto_mesh, make_debug_mesh,
                                     make_production_mesh)
from repro_torch.models import registry
from repro_torch.runtime import elastic as tel
from repro_torch.sharding import specs as ts
from repro_torch.sharding.placement import Placement

ARCHS = ASSIGNED_ARCHS + ("vit-base-16",)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "3x1": ((3, 1), ("data", "model"))}
MODES = ("local", "prism", "voltage")
KINDS = {"train": dict(train=True), "inference": {},
         "decode": dict(decode=True)}
L = 4

_ABSTRACT = {}


def _abstract(arch):
    """(JAX config, port config, JAX abstract params, port meta params)."""
    if arch not in _ABSTRACT:
        jcfg, cfg = jget(arch), get_config(arch)
        _ABSTRACT[arch] = (jcfg, cfg, jreg.abstract_params(jcfg),
                           registry.abstract_params(cfg))
    return _ABSTRACT[arch]


def _plans(mesh_id, mode, kind, jcfg, cfg):
    shape, names = MESHES[mesh_id]
    jp = js.make_plan(AbstractMesh(shape, names), jcfg, JMode(mode), L=L,
                      **KINDS[kind])
    tp = ts.make_plan(make_auto_mesh(shape, names), cfg, ExchangeMode(mode),
                      L=L, **KINDS[kind])
    return jp, tp


def _jax_specs(shardings):
    return {js._path_str(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_flatten_with_path(shardings)[0]}


def _port_specs(shardings):
    return {k: tuple(s.spec) for k, s in shardings.items()}


def _same(got, want, what):
    assert got.keys() == want.keys(), (what, sorted(set(got) ^ set(want)))
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, (what, bad)


@pytest.mark.parametrize("arch,mesh_id", list(itertools.product(ARCHS,
                                                                MESHES)))
def test_param_and_optimizer_specs_match_jax(arch, mesh_id):
    jcfg, cfg, jparams, tparams = _abstract(arch)
    for mode, kind in itertools.product(MODES, KINDS):
        jp, tp = _plans(mesh_id, mode, kind, jcfg, cfg)
        _same(_port_specs(ts.param_shardings(tp, cfg, tparams)),
              _jax_specs(js.param_shardings(jp, jcfg, jparams)),
              (mode, kind, "params"))
        _same(_port_specs(ts.opt_state_shardings(tp, cfg, tparams)),
              _jax_specs(js.opt_state_shardings(jp, jcfg, jparams)),
              (mode, kind, "optimizer state"))


def test_layout_shapes_match_jax():
    """The port's lists keyed and stacked as the JAX package's leaves."""
    for arch in ARCHS:
        jcfg, cfg, jparams, tparams = _abstract(arch)
        want = {js._path_str(p): tuple(leaf.shape) for p, leaf in
                jax.tree_util.tree_flatten_with_path(jparams)[0]}
        got = {k: s.shape for k, s in
               ts.jax_layout_shapes(tparams, cfg).items()}
        assert got == want, arch


BATCHES = ((32, 4096), (3, 130))


@pytest.mark.parametrize("arch,mesh_id", list(itertools.product(ARCHS,
                                                                MESHES)))
def test_batch_and_cache_specs_match_jax(arch, mesh_id):
    jcfg, cfg, _, _ = _abstract(arch)
    for mode, kind in itertools.product(MODES, KINDS):
        jp, tp = _plans(mesh_id, mode, kind, jcfg, cfg)
        skind = {"train": "train", "inference": "prefill",
                 "decode": "decode"}[kind]
        for B, N in BATCHES:
            jin = jreg.input_specs(jcfg, JShape("s", N, B, skind))
            tin = registry.input_specs(cfg, ShapeSpec("s", N, B, skind))
            want = {k: tuple(s.spec) for k, s in js.batch_shardings(
                jp, jcfg, jin, skind).items()}
            _same(_port_specs(ts.batch_shardings(tp, cfg, tin, skind)),
                  want, (mode, kind, B, N, "batch"))
        if cfg.family == "vit":
            continue                   # an encoder: no decode cache
        for B, S in BATCHES:
            jc, tc = _caches(arch, B, S, jp.xcfg, tp.xcfg)
            _same(_port_specs(ts.cache_shardings(tp, cfg, tc)),
                  _jax_specs(js.cache_shardings(jp, jcfg, jc)),
                  (mode, kind, B, S, "cache"))


_CACHES = {}


def _caches(arch, B, S, jx, tx):
    """(JAX abstract cache, port meta cache) of (arch, B, S) under the
    plans' partitions (the memory families pad their memory by them)."""
    key = (arch, B, S, jx.seq_shards, jx.L)
    if key not in _CACHES:
        jcfg, cfg, _, _ = _abstract(arch)
        _CACHES[key] = (
            jreg.abstract_cache(jcfg, JShape("d", S, B, "decode"), jx),
            registry.abstract_cache(cfg, ShapeSpec("d", S, B, "decode"), tx))
    return _CACHES[key]


@pytest.mark.parametrize("mesh_id,mode,kind", list(itertools.product(
    MESHES, MODES, KINDS)))
def test_make_plan_fields_and_xcfg_match_jax(mesh_id, mode, kind):
    for arch in ARCHS:
        jcfg, cfg, _, _ = _abstract(arch)
        jp, tp = _plans(mesh_id, mode, kind, jcfg, cfg)
        assert dict(tp.mesh.shape) == dict(jp.mesh.shape)
        assert tp.mesh.axis_names == tuple(jp.mesh.axis_names)
        for f in ("batch_axes", "tp_axis", "seq_axis", "fsdp", "L",
                  "decode", "train"):
            assert getattr(tp, f) == getattr(jp, f), (arch, f)
        assert tp.mode.value == jp.mode.value
        jx, tx = jp.xcfg, tp.xcfg
        assert (tx.mode.value, tx.seq_axis, tx.seq_shards, tx.L,
                tx.batch_axes) == (jx.mode.value, jx.seq_axis, jx.seq_shards,
                                   jx.L, jx.batch_axes), arch
    assert ts._param_gb(cfg) == js._param_gb(jcfg)


def test_meshes():
    assert dict(make_production_mesh().shape) == {"data": 16, "model": 16}
    m = make_production_mesh(multi_pod=True)
    assert dict(m.shape) == {"pod": 2, "data": 16, "model": 16}
    assert m.size == 512 and m.coords(511) == {"pod": 1, "data": 15,
                                                "model": 15}
    m = make_debug_mesh()
    assert dict(m.shape) == {"data": 4, "model": 2}
    assert m.lines("model") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert m.lines("data") == [[0, 2, 4, 6], [1, 3, 5, 7]]


class _AbstractMeshOf:
    """``jax.sharding.Mesh`` of a grid of ids → the AbstractMesh of its
    shape (the elastic manager's mesh, on a host with one device)."""

    def __call__(self, devs, names):
        return AbstractMesh(np.asarray(devs).shape, tuple(names))


def _same_plan(t, j):
    (tmesh, tplan), (jmesh, jplan) = t, j
    assert dict(tmesh.shape) == dict(jmesh.shape)
    for f in ("batch_axes", "seq_axis", "fsdp", "L", "decode", "train"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    assert tplan.xcfg.seq_shards == jplan.xcfg.seq_shards


@pytest.mark.parametrize("mode", MODES)
def test_elastic_meshes_match_jax(mode):
    jcfg, cfg, _, _ = _abstract("llama3.2-1b")
    ids = list(range(32))
    with mock.patch.object(jax.sharding, "Mesh", _AbstractMeshOf()), \
            mock.patch.object(jax, "devices", lambda: list(ids)):
        for n in range(1, 33):
            j = jel.ElasticMeshManager(jcfg, JMode(mode), L=L,
                                       devices=ids[:n])
            t = tel.ElasticMeshManager(cfg, ExchangeMode(mode), L=L,
                                       devices=ids[:n])
            _same_plan(t.best_mesh(), j.best_mesh())
            assert t.best_mesh()[0].devices.reshape(-1).tolist() == \
                ids[:int(np.prod(tel.largest_mesh_shape(n)))]
            _same_plan(tel.replan_for_failure(cfg, ExchangeMode(mode), n, L),
                       jel.replan_for_failure(jcfg, JMode(mode), n, L))
            shape = (n, 1) if n % 2 else (n // 2, 2)
            _same_plan(t.build(shape, ("data", "model")),
                       j.build(shape, ("data", "model")))
        j = jel.ElasticMeshManager(jcfg, JMode(mode), L=L, devices=ids[:8])
        t = tel.ElasticMeshManager(cfg, ExchangeMode(mode), L=L,
                                   devices=ids[:8])
        _same_plan(t.drop([5, 6]), j.drop([5, 6]))
        assert t.devices == j.devices


@pytest.mark.parametrize("mode,mesh_shape", [("prism", (2, 2)),
                                             ("voltage", (4, 2)),
                                             ("local", (3, 1))])
def test_placement_blocks_tile_every_leaf(mode, mesh_shape):
    """Every rank's param (and optimizer) blocks of a leaf tile the whole
    leaf exactly once a block, and each optimizer block lies inside its
    rank's param block (the reduced llama at 4 layers: small leaves, every
    rule of the full widths)."""
    cfg = get_config("llama3.2-1b").reduced(n_layers=4)
    tparams = registry.abstract_params(cfg)
    mesh = make_auto_mesh(mesh_shape, ("data", "model"))
    plan = ts.make_plan(mesh, cfg, ExchangeMode(mode), L=L, train=True)
    places = [Placement(plan, cfg, tparams, coords=mesh.coords(r))
              for r in range(mesh.size)]
    for k, ent in places[0].index_of.items():
        for specs in ("spec", "opt_spec"):
            cover = np.zeros(ent.shape, np.int32)
            blocks = set()
            for pl in places:
                idx = pl.index(k, getattr(pl, specs)[k])
                blocks.add(tuple((s.start, s.stop) for s in idx))
                if specs == "opt_spec":
                    outer = pl.index(k, pl.spec[k])
                    assert all(o.start <= i.start and i.stop <= o.stop
                               for i, o in zip(idx, outer)), k
            for b in blocks:
                cover[tuple(slice(*s) for s in b)] += 1
            assert (cover == 1).all(), (k, specs)


def test_placement_refuses_tensor_parallelism():
    """Once a refusal naming ROADMAP [13.7]; now a ``local`` plan on a
    model axis over 1 is placed: the heads, the MLP and the vocabulary
    split over ``model`` (the tree the model runs on holds their halves),
    every other leaf whole."""
    _, cfg, _, tparams = _abstract("llama3.2-1b")
    plan = ts.make_plan(make_auto_mesh((2, 2), ("data", "model")), cfg,
                        ExchangeMode.LOCAL, train=True)
    place = Placement(plan, cfg, tparams, coords={"data": 0, "model": 1})
    assert set(place.tp_dim) == {"embed/table"} | {
        f"layers/{k}" for k in ("attn/wq", "attn/wk", "attn/wv", "attn/wo",
                                "mlp/w_up", "mlp/w_gate", "mlp/w_down")}
    for k, ent in place.index_of.items():
        held = place.block_shape(k, place.held[k])
        if k in place.tp_dim:
            d = place.tp_dim[k]
            assert held[d] * 2 == ent.shape[d] and \
                place.spec[k][d] == "model"
        else:
            assert held == ent.shape, k
