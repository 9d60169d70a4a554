"""`repro_torch.api` — the adaptive-inference surface of the port.

* :class:`ExecutionPlan` — mode + CR/L + sequence-partition layout.
* :class:`ExchangeStrategy` / :func:`register_strategy` — the exchange
  registry (local / voltage / prism / prism_sim).
* :class:`InferenceSession` — params, per-plan executables, bandwidth
  observation, profiling, policy, dispatch, generation and calibration.
"""
from repro_torch.api.plan import ExecutionPlan
from repro_torch.api.session import (CalibrationReport, DispatchRecord,
                                     Explanation, InferenceSession,
                                     from_trace)
from repro_torch.api.strategies import (ExchangeStrategy, get_strategy,
                                        list_strategies, register_strategy)
from repro_torch.core.exchange import ExchangeConfig, ExchangeMode
from repro_torch.core.perfmap import PerfEntry, PerfKey, PerfMap
from repro_torch.core.policy import (AdaptivePolicy, Decision, PolicyTable,
                                     SLOObjective, WeightedObjective,
                                     resolve_objective)
from repro_torch.core.profiler import profile_measured, profile_simulated
from repro_torch.profiling import SweepSpec

__all__ = [
    "ExecutionPlan", "InferenceSession", "DispatchRecord", "Explanation",
    "CalibrationReport",
    "ExchangeStrategy", "register_strategy", "get_strategy",
    "list_strategies", "ExchangeConfig", "ExchangeMode",
    "PerfKey", "PerfEntry", "PerfMap", "AdaptivePolicy", "Decision",
    "PolicyTable", "resolve_objective", "WeightedObjective", "SLOObjective",
    "SweepSpec", "from_trace",
    "profile_simulated", "profile_measured",
]
