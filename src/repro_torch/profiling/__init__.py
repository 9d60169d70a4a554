"""`repro_torch.profiling` — the pluggable profiling subsystem.

The paper's contribution is *profiling-driven* adaptation; this package makes
the profile→policy pipeline a first-class API surface:

* :class:`ProfileBackend` registry (``simulated`` / ``measured`` / ``trace``)
  — how a performance map gets filled.
* :class:`HardwareProfile` / :class:`LinkProfile` — what it was profiled on
  (serialized into the map, schema v2).
* :class:`Objective` hierarchy — what the policy optimizes (latency, energy,
  weighted tradeoff, SLO-constrained), with string back-compat.
* :class:`PolicyTable` — the compiled dense decision grid behind
  ``AdaptivePolicy``: O(1) ``decide()``, bandwidth interpolation,
  table-derived crossover artifacts.

``InferenceSession.profile(backend=...)`` and ``session.calibrate()`` are
the runtime entry points (see ``repro_torch.api``).
"""
from repro_torch.profiling.hardware import (H100_GLOO_STAGED, H100_SXM,
                                            JETSON_ORIN_NANO,
                                            PRESET_HARDWARE, PRESET_LINKS,
                                            TPU_ICI, TPU_V5E, WIFI_GLOO,
                                            HardwareProfile, LinkProfile,
                                            to_edge_constants)
from repro_torch.profiling.objectives import (EnergyObjective, LatencyObjective,
                                        Objective, ObjectiveLike,
                                        SLOObjective, WeightedObjective,
                                        resolve_objective)
from repro_torch.profiling.sweep import (PAPER_BATCHES, PAPER_BWS, PAPER_CRS,
                                   SweepSpec, sweep_cost,
                                   workload_from_config)
from repro_torch.profiling.table import BatchPlan, Decision, PolicyTable
from repro_torch.profiling.backends import (MeasuredBackend, ProfileBackend,
                                      ProfileContext, SimulatedBackend,
                                      TraceBackend, get_backend,
                                      list_backends, register_backend)

__all__ = [
    "ProfileBackend", "ProfileContext", "register_backend", "get_backend",
    "list_backends", "SimulatedBackend", "MeasuredBackend", "TraceBackend",
    "HardwareProfile", "LinkProfile", "to_edge_constants",
    "JETSON_ORIN_NANO", "WIFI_GLOO", "TPU_V5E", "TPU_ICI",
    "H100_SXM", "H100_GLOO_STAGED", "PRESET_HARDWARE", "PRESET_LINKS",
    "Objective", "ObjectiveLike", "LatencyObjective", "EnergyObjective",
    "WeightedObjective", "SLOObjective", "resolve_objective",
    "PolicyTable", "Decision", "BatchPlan",
    "SweepSpec", "sweep_cost", "workload_from_config",
    "PAPER_BATCHES", "PAPER_CRS", "PAPER_BWS",
]
