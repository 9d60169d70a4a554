"""One train step of the port against the JAX package's
``build_train_step`` (CPU, reduced f32 configs, the JAX weights carried
across by the bridge, one process): reduced llama3.2-1b and internlm2-1.8b
under ``local`` and ``prism_sim`` (P 4, L 2), with ``grad_accum`` 1 and 2:
each microbatch's gradient leaf by leaf, the loss, nll, aux, grad_norm
and lr, and the updated params (tolerances and the line drawn for
AdamW's first step in ``tests/_train_oracle.py:check_step`` and PERF.md
§6).
"""
import pytest

from _train_oracle import check_step
from repro.core.exchange import ExchangeConfig as JX
from repro.core.exchange import ExchangeMode as JM
from repro_torch.core.exchange import ExchangeConfig, ExchangeMode

PLANS = {"local": (JX(), ExchangeConfig()),
         "prism_sim": (JX(JM.PRISM_SIM, "seq", 4, L=2),
                       ExchangeConfig(ExchangeMode.PRISM_SIM, "seq", 4,
                                      L=2))}


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("arch", ["llama3.2-1b", "internlm2-1.8b"])
def test_train_step_matches_jax(arch, plan, grad_accum):
    jx, tx = PLANS[plan]
    m = check_step(arch, jx, tx, grad_accum=grad_accum, B=2, N=32)
    assert float(m["grad_norm"]) > 0
