"""One ``local`` train step of the port against the JAX package's
``build_train_step`` for one reduced f32 config of every other family
(CPU, one process, the JAX weights carried across by the bridge):
gemma2 (windowed local/global layers, window 4), the moe family with its
aux loss (deepseek-moe-16b) and MLA (deepseek-v2-236b), the memory models
(whisper-large-v3; llama-3.2-vision-11b with its gates at 0.5), hybrid
(hymba-1.5b) and ssm (xlstm-350m).  Tolerances as
``tests/_train_oracle.py:check_step`` (PERF.md §6).
"""
import pytest

from _train_oracle import check_step
from repro.core.exchange import ExchangeConfig as JX
from repro_torch.core.exchange import ExchangeConfig

FAMILIES = {"gemma2-27b": dict(over={"window": 4}),
            "deepseek-moe-16b": {},
            "deepseek-v2-236b": {},
            "whisper-large-v3": {},
            "llama-3.2-vision-11b": dict(gates=True),
            "hymba-1.5b": {},
            "xlstm-350m": {}}


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_local_train_step_matches_jax(arch):
    m = check_step(arch, JX(), ExchangeConfig(), B=2, N=16, **FAMILIES[arch])
    if arch == "deepseek-moe-16b":
        assert float(m["aux"]) > 0
