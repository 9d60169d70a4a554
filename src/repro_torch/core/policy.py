"""Runtime adaptive execution policy (paper §3.3).

Given an arriving batch size and the observed bandwidth, pick the execution
mode — ``local`` or ``distributed(best CR)`` — minimizing the configured
:class:`~repro_torch.profiling.objectives.Objective` (latency, energy, weighted
tradeoff, or SLO-constrained; the legacy ``"latency"``/``"energy"`` strings
still work).

``AdaptivePolicy`` compiles the performance map into a dense
:class:`~repro_torch.profiling.table.PolicyTable` per objective (one map walk,
then O(1) ``decide()`` with bandwidth interpolation between profiled grid
points) and exposes the paper-reported crossover artifacts derived from it.
Out-of-grid batches snap to the nearest profiled batch and the decision is
flagged ``extrapolated``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.core.perfmap import PerfMap
from repro_torch.profiling.objectives import (EnergyObjective, LatencyObjective,
                                        Objective, ObjectiveLike,
                                        SLOObjective, WeightedObjective,
                                        resolve_objective)
from repro_torch.profiling.table import BatchPlan, Decision, PolicyTable

__all__ = ["AdaptivePolicy", "BatchPlan", "Decision", "Objective",
           "ObjectiveLike", "LatencyObjective", "EnergyObjective",
           "WeightedObjective", "SLOObjective", "resolve_objective",
           "PolicyTable"]


class AdaptivePolicy:
    def __init__(self, perfmap: PerfMap,
                 allow_modes: Tuple[str, ...] = ("local", "prism")):
        """``allow_modes`` defaults to the paper's deployment (voltage is
        profiled for reporting but never selected — it loses everywhere)."""
        self.pm = perfmap
        self.allow = allow_modes
        self._tables: Dict[Tuple, PolicyTable] = {}

    def table(self, objective: ObjectiveLike = "latency") -> PolicyTable:
        """The compiled decision table for one objective (cached)."""
        obj = resolve_objective(objective)
        key = obj.cache_key()
        t = self._tables.get(key)
        if t is None:
            t = self._tables[key] = PolicyTable.compile(self.pm, self.allow,
                                                        obj)
        return t

    def invalidate(self) -> None:
        """Drop compiled tables (call after mutating the perf map, e.g. a
        calibration pass)."""
        self._tables.clear()

    def decide(self, batch: int, bandwidth_mbps: float,
               objective: ObjectiveLike = "latency") -> Decision:
        return self.table(objective).decide(batch, bandwidth_mbps)

    def nearest_batch(self, batch: int) -> int:
        """Snap an arriving batch size to the nearest profiled one (ties
        toward the smaller batch) — the same snapping ``decide()`` uses."""
        return self.table().nearest_batch(batch)

    # --- paper-reported artifacts (table-derived) --------------------------

    def batch_crossover(self, bandwidth_mbps: float,
                        objective: ObjectiveLike = "latency"
                        ) -> Optional[int]:
        """Smallest profiled batch at which distributed wins (paper: 8)."""
        return self.table(objective).batch_crossover(bandwidth_mbps)

    def bandwidth_crossover(self, batch: int,
                            objective: ObjectiveLike = "latency"
                            ) -> Optional[float]:
        """Smallest profiled bandwidth at which distributed wins at
        ``batch`` (paper: ≈340 Mbps at B=8)."""
        return self.table(objective).bandwidth_crossover(batch)
