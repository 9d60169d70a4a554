"""The port's small helpers against their JAX functions on the CPU, from
the same numpy inputs: ``utils/tree.py``'s ``param_bytes``, ``tree_norm``,
``tree_zeros_like``, ``tree_add`` and ``tree_scale``; ``configs``'
``ASSIGNED_ARCHS``; ``core/prism_attention.py``'s
``prism_attention_from_projected`` and ``segment_means_nd``.

Tolerances: sums of f32 squares in another order ≤ 1e-6 relative; the
attention (f32) ≤ 1e-5; the rest exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import prism_attention as jpa
from repro.models import registry as jreg
from repro.utils import tree as jtree
from repro_torch import configs as tconfigs
from repro_torch.core import prism_attention as tpa
from repro_torch.models.bridge import params_from_numpy
from repro_torch.utils import tree as ttree


def _trees(seed=0):
    """(a JAX tree, the same tree in the port) of f32 leaves."""
    rng = np.random.RandomState(seed)
    a = {"w": rng.randn(3, 4).astype(np.float32),
         "layers": [{"b": rng.randn(5).astype(np.float32)},
                    {"b": rng.randn(5).astype(np.float32)}],
         "s": np.float32(rng.randn())}
    return (jax.tree.map(jnp.asarray, a),
            ttree.tree_map(lambda x: torch.from_numpy(np.array(x)), a))


def _same(got, want):
    for g, w in zip(ttree.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_param_bytes_match(dtype):
    cfg = jconfigs.get_config("llama3.2-1b").reduced(dtype=dtype)
    jp = jreg.init_params(cfg, seed=0)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg)
    assert ttree.param_bytes(tp) == jtree.param_bytes(jp) > 0
    meta = ttree.tree_map(lambda t: t.to("meta"), tp)
    assert ttree.param_bytes(meta) == jtree.param_bytes(jp)


def test_tree_norm_matches():
    ja, ta = _trees()
    got = ttree.tree_norm(ta)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(jtree.tree_norm(ja)),
                               rtol=1e-6)


def test_tree_arithmetic_matches():
    ja, ta = _trees(1)
    jb, tb = _trees(2)
    _same(ttree.tree_zeros_like(ta), jtree.tree_zeros_like(ja))
    _same(ttree.tree_add(ta, tb), jtree.tree_add(ja, jb))
    _same(ttree.tree_scale(ta, 0.37), jtree.tree_scale(ja, 0.37))


def test_assigned_archs_match():
    assert tconfigs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert "vit-base-16" not in tconfigs.ASSIGNED_ARCHS


def test_segment_means_nd_matches():
    x = np.random.RandomState(3).randn(2, 12, 2, 16).astype(np.float32)
    got = tpa.segment_means_nd(torch.from_numpy(x), 4)
    want = np.asarray(jpa.segment_means_nd(jnp.asarray(x), 4))
    assert tuple(got.shape) == want.shape == (2, 4, 2, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_prism_attention_from_projected_matches(causal):
    rng = np.random.RandomState(4)
    q = rng.randn(2, 12, 4, 16).astype(np.float32)
    k, v = (rng.randn(2, 12, 2, 16).astype(np.float32) for _ in range(2))
    got = tpa.prism_attention_from_projected(
        *(torch.from_numpy(a) for a in (q, k, v)), 0, L=4, seg_size=3,
        causal=causal)
    want = np.asarray(jpa.prism_attention_from_projected(
        *(jnp.asarray(a) for a in (q, k, v)), 0, L=4, seg_size=3,
        causal=causal))
    assert tuple(got.shape) == want.shape == (2, 12, 4, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
