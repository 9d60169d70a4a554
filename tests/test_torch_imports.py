"""The port stands alone: it imports neither JAX, nor anything of `repro`,
nor `ml_dtypes` (which ships with JAX)."""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

GUARD = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["ml_dtypes"] = None    # ships with jax; the card has neither
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m == "repro" or
                m.startswith("repro."))
assert not leaked, leaked
assert not any(m.split(".")[0] in ("jax", "ml_dtypes")
               for m in sys.modules if sys.modules[m] is not None)
print(" ".join(names))
print(len(names))
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", GUARD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 30       # every module imported
    assert "repro_torch.transport.executor" in out.stdout.split()
    assert "repro_torch.configs.gemma2_27b" in out.stdout.split()
    for name in MOE_FAMILY:
        assert name in out.stdout.split()
    for name in FLEET_TIER:
        assert name in out.stdout.split()
    for name in RECURRENT_FAMILIES:
        assert name in out.stdout.split()
    for name in EXAMPLES:
        assert name in out.stdout.split()
    for name in MESH:
        assert name in out.stdout.split()


IMPORT_LINE = re.compile(r"^\s*(import jax|from jax|import repro\b|"
                         r"from repro(\.| )|import ml_dtypes|from ml_dtypes)")
FLEET_TIER = ("repro_torch.fleet.router", "repro_torch.rpc.worker",
              "repro_torch.chaos.controller")
RECURRENT_FAMILIES = ("repro_torch.models.ssm", "repro_torch.core.handoff",
                      "repro_torch.configs.hymba_1_5b",
                      "repro_torch.configs.xlstm_350m")
MESH = ("repro_torch.launch.mesh", "repro_torch.sharding.specs",
        "repro_torch.sharding.placement", "repro_torch.runtime.elastic")
EXAMPLES = ("repro_torch.examples.quickstart",
            "repro_torch.examples.serve_adaptive",
            "repro_torch.examples.train_lm",
            "repro_torch.examples.finetune_prism",
            "repro_torch.models.remat")
MOE_FAMILY = ("repro_torch.models.moe", "repro_torch.models.mla",
              "repro_torch.configs.deepseek_moe_16b",
              "repro_torch.configs.deepseek_v2_236b")


def test_no_source_line_imports_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = [f"{f.relative_to(ROOT)}:{i}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if IMPORT_LINE.match(line)]
    assert len(files) > 30 and not bad, bad


def test_moe_family_sources_import_nothing_of_jax():
    """The moe family's modules (experts, MLA, both configs) and the
    exchange that carries the MLA latent import neither JAX, nor `repro`,
    nor `ml_dtypes`, in any line."""
    for name in MOE_FAMILY + ("repro_torch.core.exchange",
                              "repro_torch.models.transformer"):
        path = ROOT / "src" / (name.replace(".", "/") + ".py")
        bad = [i for i, line in enumerate(path.read_text().splitlines(), 1)
               if IMPORT_LINE.match(line)]
        assert not bad, (name, bad)


def test_fleet_tier_sources_import_nothing_of_jax():
    """The fleet tier's modules (router, RPC worker and wire, chaos) import
    neither JAX, nor `repro`, nor `ml_dtypes`, in any line — lazy imports
    inside functions included."""
    for name in FLEET_TIER + ("repro_torch.rpc.wire", "repro_torch.rpc.client",
                              "repro_torch.fleet.registry",
                              "repro_torch.launch.fleet"):
        path = ROOT / "src" / (name.replace(".", "/") + ".py")
        bad = [i for i, line in enumerate(path.read_text().splitlines(), 1)
               if IMPORT_LINE.match(line)]
        assert not bad, (name, bad)
