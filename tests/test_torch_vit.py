"""Reduced ViT-B/16 in the port against the JAX package's ``forward_vit``,
in f32 on the CPU, with the JAX weights carried across by the params
bridge.

* port ``local`` (one process) vs JAX ``local``;
* port ``voltage`` across 2 and 4 gloo ranks vs JAX ``local`` (Voltage is
  exact full attention);
* port ``prism(L=20)`` across 2 ranks and ``prism(L=5)`` across 4 vs JAX
  ``forward_vit`` with ``repro.core.exchange.prism_prefill_attention``
  replaced by the per-partition oracle of ``tests/_exchange_oracle.py``
  (the JAX mesh path does not run on the installed JAX);
* ``dispatch`` under a seq group runs rank 0's decision on every rank.

Max abs logit difference ≤ 1e-4.  Each world size runs all its plans in
one spawn (join timeout 120 s).
"""
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import _torch_ranks
from _exchange_oracle import prism_oracle
from repro.configs import get_config as jax_config
from repro.core import exchange as jx
from repro.data.pipeline import SyntheticImageDataset as JaxImages
from repro.models import registry as jreg
from repro.models import vit as jvit
from repro_torch.api import ExecutionPlan, InferenceSession
from repro_torch.core.seq_group import spawn
from repro_torch.data import SyntheticImageDataset
from repro_torch.models.bridge import params_from_numpy

REDUCED = {"dtype": "float32"}
ATOL = 1e-4
B = 4
# B = 4 on the reduced config's simulated profile: local at 400 Mbps,
# prism at 1000 Mbps — the two ranks would decide apart on their own
DISPATCH_BW = (1000.0, 400.0, 400.0, 400.0)


@pytest.fixture(scope="module")
def jax_side():
    cfg = jax_config("vit-base-16").reduced(**REDUCED)
    params = jreg.init_params(cfg, seed=0)
    images, _ = JaxImages(batch_size=B, seed=3).sample()
    return cfg, params, images


def _jax_logits(jax_side, mode, P=1, L=0):
    cfg, params, images = jax_side
    xcfg = (jx.ExchangeConfig() if mode == "local" else
            jx.ExchangeConfig(jx.ExchangeMode.PRISM, seq_axis="seq",
                              seq_shards=P, L=L))
    with mock.patch.object(jx, "prism_prefill_attention", prism_oracle):
        return np.asarray(jvit.forward_vit(params, images, cfg, xcfg))


@pytest.fixture(scope="module")
def np_params(jax_side):
    return jax.tree.map(np.asarray, jax_side[1])


_RUNS = {}


def _ranks(np_params, images, P, plans):
    if P not in _RUNS:
        _RUNS[P] = spawn(_torch_ranks.vit_logits, P, np_params, REDUCED,
                         images, plans, DISPATCH_BW, timeout=120)
    return _RUNS[P]


def _diff(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def test_images_are_the_jax_packages():
    a, la = SyntheticImageDataset(batch_size=3, seed=5).sample()
    b, lb = JaxImages(batch_size=3, seed=5).sample()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)


def test_bridge_carries_the_stacked_vit_layers(jax_side, np_params):
    cfg = jax_side[0]
    tp = params_from_numpy(np_params, cfg)
    assert len(tp["layers"]) == cfg.n_layers
    for i in range(cfg.n_layers):
        np.testing.assert_array_equal(
            tp["layers"][i]["attn"]["wk"].numpy(),
            np_params["layers"]["attn"]["wk"][i])
    assert tp["pos"].shape == (1, jvit.N_TOKENS, cfg.d_model)


def test_local_matches_jax_local(jax_side, np_params):
    session = InferenceSession.from_config(
        "vit-base-16", reduced=REDUCED, device="cpu",
        params=params_from_numpy(np_params, jax_side[0]))
    got = session.run("local", {"images": torch.from_numpy(jax_side[2])})
    assert got.shape == (B, jax_side[0].vocab_size)
    assert _diff(got, _jax_logits(jax_side, "local")) <= ATOL


@pytest.mark.parametrize("P", [2, 4])
def test_voltage_across_ranks_matches_jax_local(jax_side, np_params, P):
    plans = ("voltage", "prism:20") if P == 2 else ("voltage", "prism:5")
    runs = _ranks(np_params, jax_side[2], P, plans)
    want = _jax_logits(jax_side, "local")
    for logits, *_ in runs:
        assert _diff(logits["voltage"], want) <= ATOL


@pytest.mark.parametrize("P,L", [(2, 20), (4, 5)])
def test_prism_across_ranks_matches_the_jax_oracle(jax_side, np_params, P,
                                                   L):
    plans = ("voltage", f"prism:{L}")
    runs = _ranks(np_params, jax_side[2], P, plans)
    want = _jax_logits(jax_side, "prism", P, L)
    for logits, *_ in runs:
        assert _diff(logits[f"prism:{L}"], want) <= ATOL
    # every rank returns rank 0's logits
    for logits, *_ in runs[1:]:
        np.testing.assert_array_equal(logits[f"prism:{L}"],
                                      runs[0][0][f"prism:{L}"])


@pytest.mark.parametrize("P", [2, 4])
def test_dispatch_takes_rank_zeros_decision(jax_side, np_params, P):
    plans = ("voltage", "prism:20") if P == 2 else ("voltage", "prism:5")
    runs = _ranks(np_params, jax_side[2], P, plans)
    keys = {key for _, key, _, _ in runs}
    modes = {mode for _, _, mode, _ in runs}
    assert len(keys) == 1 and modes == {"prism"}
    assert runs[1][3] == DISPATCH_BW[1]      # rank 1 saw a slower link
    # on its own, rank 1's bandwidth picks the other plan
    alone = InferenceSession.from_config(
        "vit-base-16", reduced=REDUCED, device="cpu",
        plans=[ExecutionPlan.local(),
               ExecutionPlan.prism(L=5, cr=9.85, seq_shards=P)])
    alone.profile(backend="simulated")
    assert alone.decide(B, DISPATCH_BW[1]).mode == "local"
