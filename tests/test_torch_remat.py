"""Per-layer rematerialisation in training (``repro_torch.models.remat``)
changes no gradient: on the CPU, each case's loss and gradient with it
(the default) equal those without it (``remat.disabled()``) bit for bit,
in one process and on every rank of 2 and 4 gloo ranks (rank body
``tests/_torch_ranks.py:remat_grads``; reduced f32 configs, the JAX
weights carried across by the bridge).

The cases cover every kind of layer walk and every staged collective a
rematerialised layer calls: llama under ``local``, ``voltage`` (the
gather), the ring, ``prism`` (the means' gather) and ``prism`` + int8
(the packed gather); gemma2 (on 4 ranks its windowed layer's halo
``shift``); the moe family's routing call; hymba's and xLSTM's state
hand-off (``pass_on``), with xLSTM's mLSTM and sLSTM scans kept at chunk
boundaries.  Across ranks the recompute takes every collective's output
from the layer's tape, so the bytes booked by kind, the calls, the halo
and state calls and the tags taken are those of a step without
rematerialisation, and the bytes autograd saves outside the rematerialised
regions fall (the layers save none).
"""
import concurrent.futures

import jax
import numpy as np
import pytest

import _torch_ranks
from repro.configs import get_config
from repro.models import registry as jreg
from repro_torch.core.seq_group import spawn

B = 2
LLAMA, GEMMA, MOE = "llama3.2-1b", "gemma2-27b", "deepseek-moe-16b"
HYMBA, XLSTM = "hymba-1.5b", "xlstm-350m"
F32 = {"dtype": "float32"}


def _case(arch, mode="local", N=32, **opts):
    return dict(arch=arch, reduced=F32, mode=mode, N=N, **opts)


CASES = {
    1: {"llama": _case(LLAMA), "gemma2": _case(GEMMA),
        "moe": _case(MOE), "hymba": _case(HYMBA),
        "xlstm": _case(XLSTM, N=64)},
    2: {"llama/voltage": _case(LLAMA, "voltage"),
        "llama/ring": _case(LLAMA, "voltage", overlap_chunks=2),
        "llama/prism": _case(LLAMA, "prism", L=4),
        "llama/prism+int8": _case(LLAMA, "prism", L=4, codec="int8"),
        "moe/prism": _case(MOE, "prism", L=4),
        "hymba/prism": _case(HYMBA, "prism", L=4),
        "xlstm/voltage": _case(XLSTM, "voltage", N=64)},
    4: {"llama/voltage": _case(LLAMA, "voltage"),
        "llama/prism": _case(LLAMA, "prism", L=2),
        "gemma2/prism": _case(GEMMA, "prism", L=2),
        "hymba/prism": _case(HYMBA, "prism", L=2),
        "xlstm/prism": _case(XLSTM, "prism", N=64, L=2)},
}


def _job(cases):
    params, batch = {}, {}
    for i, (label, c) in enumerate(cases.items()):
        cfg = get_config(c["arch"]).reduced(**c["reduced"])
        params[label] = jax.tree.map(np.asarray,
                                     jreg.init_params(cfg, seed=0))
        rng = np.random.RandomState(10 + i)
        toks = rng.randint(0, cfg.vocab_size, (B, c["N"] + 1))
        batch[label] = {"tokens": toks[:, :-1].astype(np.int32),
                        "labels": toks[:, 1:].astype(np.int32)}
    return dict(cases=cases, params=params, batch=batch)


@pytest.fixture(scope="module")
def results():
    """{world: [per rank: {label: remat_case result}]}; both spawns run
    in the background while the one-process cases run here."""
    jobs = {w: _job(CASES[w]) for w in (2, 4)}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = {w: pool.submit(spawn, _torch_ranks.remat_grads, w, jobs[w],
                               timeout=300) for w in jobs}
        one = _job(CASES[1])
        out = {1: [{label: _torch_ranks.remat_case(
            None, c, one["params"][label], one["batch"][label])
            for label, c in CASES[1].items()}]}
        out.update({w: f.result() for w, f in futs.items()})
    return out


CELLS = [(w, label) for w in (1, 2, 4) for label in CASES[w]]


@pytest.mark.parametrize("world,label", CELLS,
                         ids=[f"{w}-{label}" for w, label in CELLS])
def test_gradients_equal_without_remat_bit_for_bit(results, world, label):
    for rank, r in enumerate(results[world]):
        on, off = r[label]["on"], r[label]["off"]
        np.testing.assert_array_equal(on["loss"], off["loss"])
        assert len(on["grads"]) == len(off["grads"])
        for i, (g, h) in enumerate(zip(on["grads"], off["grads"])):
            np.testing.assert_array_equal(
                g, h, err_msg=f"rank {rank} leaf {i}")
        assert any(np.abs(g).max() > 0 for g in on["grads"])


@pytest.mark.parametrize("world,label", CELLS,
                         ids=[f"{w}-{label}" for w, label in CELLS])
def test_saved_bytes_fall_and_the_wire_is_unchanged(results, world, label):
    for r in results[world]:
        on, off = r[label]["on"], r[label]["off"]
        assert 0 < on["saved"] < off["saved"] / 2, (on["saved"],
                                                   off["saved"])
        if world > 1:
            assert on["booked"] == off["booked"]
            assert on["tags"] == off["tags"]
            assert on["booked"]["calls"] > 0
            if label.startswith("gemma2") and world == 4:
                assert on["booked"]["halo_calls"] > 0
            if label.startswith(("hymba", "xlstm")):
                assert on["booked"]["state_calls"] > 0
