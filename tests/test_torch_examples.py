"""The port's examples (``repro_torch.examples``) against the JAX
package's own examples, on the CPU, from the same config, seed and
weights (the JAX example's seeded draw carried across by
``models.bridge.params_from_numpy``).

* ``quickstart``, ``serve_adaptive``: each JAX example runs as it is (its
  ``main()``; the quickstart's map is saved under the test's temporary
  directory, not ``/tmp``) and prints its lines; the twin prints its own.
  The lines are held equal with the wall times and the map's path
  masked: the profile's size and hardware, every decision with its CR
  and expected ms/sample, the crossovers, the explanation table, the
  objectives' choices, the extrapolated flags, the ``calibrate`` counts,
  the ViT agreement and the greedy tokens (bf16, as the examples run).
* ``train_lm``: the JAX example's ``main()`` and the twin's, both for 4
  steps of each mode with the config in f32 (bf16 rounds apart between
  the packages) and the JAX checkpoints under the test's directory: each
  step's loss ≤ 1e-5 relative, and both print ``TRAIN LM OK``.
* ``finetune_prism``: ``benchmarks/accuracy_prism.py``'s ``_train`` and
  the twin's, 2 steps under ``local`` and 2 through ``prism_sim`` at CR
  9.9, in f32: each step's loss ≤ 1e-5 relative; ``_acc`` equal under
  both plans; the twin's ``main`` at 2 + 1 steps (one evaluation batch)
  prints ``FINETUNE PRISM OK``.
"""
import dataclasses
import importlib.util
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from benchmarks import accuracy_prism as jacc
from repro.api import ExecutionPlan as JPlan
from repro.configs import get_config as jax_config
from repro.core.perfmap import PerfMap as JPerfMap
from repro.core.segment_means import cr_to_L
from repro.data.pipeline import SyntheticImageDataset as JImages
from repro.models import registry as jax_registry
from repro_torch.api import ExecutionPlan as TPlan
from repro_torch.data.pipeline import SyntheticImageDataset as TImages
from repro_torch.examples import (finetune_prism, quickstart,
                                  serve_adaptive, train_lm)
from repro_torch.models.bridge import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]


def _jax_example(name: str):
    """The JAX package's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bridged(arch: str, seed: int = 0, **reduced):
    """The port's params of the JAX example's seeded draw."""
    cfg = jax_config(arch).reduced(**reduced)
    params = jax_registry.init_params(cfg, seed=seed)
    return params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                             device="cpu")


def _masked(text: str) -> list:
    text = re.sub(r"\(\s*[\d.]+ ms wall\)", "(· ms wall)", text)
    text = re.sub(r"configurations on (\S+) → \S+",
                  r"configurations on \1 → ·", text)
    return text.splitlines()


def _run_both(capsys, name: str, twin, params) -> tuple:
    _jax_example(name).main()
    want = capsys.readouterr().out
    twin(["--device", "cpu"], params=params)
    got = capsys.readouterr().out
    return _masked(want), _masked(got)


def test_quickstart_twin_prints_the_reference_lines(capsys, monkeypatch,
                                                    tmp_path):
    save = JPerfMap.save
    monkeypatch.setattr(JPerfMap, "save", lambda self, path: save(
        self, str(tmp_path / "jax_perfmap.json")))
    monkeypatch.setattr(quickstart.tempfile, "gettempdir",
                        lambda: str(tmp_path))
    want, got = _run_both(capsys, "quickstart", quickstart.main,
                          _bridged("vit-base-16"))
    assert got == want
    assert len(want) == 9 and want[-1] == "QUICKSTART OK"
    assert (tmp_path / "prism_perfmap_torch.json").exists()


def test_serve_adaptive_twin_prints_the_reference_lines(capsys):
    want, got = _run_both(capsys, "serve_adaptive", serve_adaptive.main,
                          _bridged("llama3.2-1b", vocab_size=128))
    assert got == want
    assert any(line.endswith("[extrapolated]") for line in want)
    assert want[-1] == "SERVE ADAPTIVE OK"


@pytest.mark.parametrize("twin", [quickstart.main, serve_adaptive.main,
                                  train_lm.main, finetune_prism.main],
                         ids=["quickstart", "serve_adaptive", "train_lm",
                              "finetune_prism"])
def test_twins_default_to_the_card(twin):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        twin(["--steps", "1"] if twin is train_lm.main else [])


def _f32(get_config):
    """``get_config`` with every config in f32."""
    return lambda arch: dataclasses.replace(get_config(arch),
                                            dtype="float32")


@pytest.mark.parametrize("mode", ["local", "prism_sim"])
def test_train_lm_twin_matches_the_reference_losses(capsys, monkeypatch,
                                                    tmp_path, mode):
    jmod = _jax_example("train_lm")
    jtc, jtr, made = jmod.TrainerConfig, jmod.Trainer, []

    class Trainer(jtr):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(jmod, "get_config", _f32(jmod.get_config))
    monkeypatch.setattr(jmod, "Trainer", Trainer)
    monkeypatch.setattr(jmod, "TrainerConfig", lambda **kw: jtc(
        **{**kw, "ckpt_dir": str(tmp_path / "jax")}))
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--steps", "4",
                                      "--mode", mode])
    jmod.main()
    want = [m["loss"] for m in made[0].metrics_log]
    monkeypatch.setattr(train_lm, "get_config", _f32(train_lm.get_config))
    cfg = jax_config("llama3.2-1b").reduced(
        vocab_size=256, n_layers=4, d_model=128, d_ff=256, dtype="float32")
    got = train_lm.main(["--steps", "4", "--mode", mode, "--device", "cpu"],
                        params=_bridged_cfg(cfg))
    out = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert out.count("TRAIN LM OK") == 2


def _bridged_cfg(cfg, seed=0):
    params = jax_registry.init_params(cfg, seed=seed)
    return params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                             device="cpu")


def _jax_losses(monkeypatch, fn):
    """``fn()`` → the losses of the steps ``accuracy_prism._train`` ran
    (its jitted step's third output)."""
    jit, losses = jax.jit, []

    def spy(f, **kw):
        step = jit(f, **kw)

        def run(*a):
            out = step(*a)
            if isinstance(out, tuple) and len(out) == 3:
                losses.append(float(out[2]))
            return out
        return run

    with monkeypatch.context() as m:
        m.setattr(jacc.jax, "jit", spy)
        fn()
    return losses


def test_finetune_prism_twin_matches_the_reference_steps(monkeypatch):
    jcfg = jax_config("vit-base-16").reduced(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=10, dtype="float32")
    tcfg = finetune_prism.vit_config("float32")
    jparams = jax_registry.init_params(jcfg, seed=0)
    tparams = _bridged_cfg(jcfg)
    L = cr_to_L(197, 2, 9.9)
    plans = {"local": (JPlan.local(), TPlan.local(), {}),
             "prism": (JPlan.prism_sim(L=L, cr=9.9, seq_shards=2),
                       TPlan.prism_sim(L=L, cr=9.9, seq_shards=2),
                       dict(lr=1e-4, seed=7))}
    for name, (jp, tp, kw) in plans.items():
        jx, tx = jp.to_exchange_config(), tp.to_exchange_config()
        steps = 2
        want = _jax_losses(monkeypatch, lambda: jacc._train(
            jcfg, jparams, jx, JImages(batch_size=16, seed=0), steps, **kw))
        got = []
        finetune_prism._train(tcfg, tparams, tx, TImages(batch_size=16,
                                                         seed=0),
                              steps, losses=got, **kw)
        assert len(got) == len(want) == steps
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
        assert finetune_prism._acc(tcfg, tparams, tx, TImages(
            batch_size=16, seed=0), n_batches=1) == jacc._acc(
            jcfg, jparams, jx, JImages(batch_size=16, seed=0), n_batches=1)


def test_finetune_prism_twin_runs_to_its_closing_line(capsys, monkeypatch):
    acc = finetune_prism._acc
    monkeypatch.setattr(finetune_prism, "_acc", lambda *a, **kw: acc(
        *a, **{**kw, "n_batches": 1}))
    cfg = jax_config("vit-base-16").reduced(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=10)
    out = finetune_prism.main(["--device", "cpu", "--train-steps", "2",
                               "--ft-steps", "1"], params=_bridged_cfg(cfg))
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "FINETUNE PRISM OK"
    assert set(out["prism"]) == {3.3, 4.95, 9.9}
    assert all(0.0 <= a <= 1.0 for a in (out["full"],
                                         *out["prism"].values(),
                                         *out["finetuned"].values()))
