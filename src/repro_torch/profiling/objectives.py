"""Optimization objectives for the adaptive policy.

The seed encoded the objective as ``Literal["latency", "energy"]`` — enough
for the paper's two headline tables, but closed to the deployments PRISM-style
systems actually face (battery budgets, latency SLOs).  ``Objective`` is now a
tiny class hierarchy; every ``objective=`` parameter accepts either an
``Objective`` instance or the legacy strings (``"latency"``/``"energy"``),
and objectives compare equal to their string names so existing
``decision.objective == "energy"`` call sites keep working.

An objective maps a profiled :class:`~repro_torch.core.perfmap.PerfEntry` to a
scalar cost; the policy table minimizes that cost per cell.
"""
from __future__ import annotations

from typing import Tuple, Union

# Candidates violating a hard constraint get pushed past every feasible cost
# but stay ordered among themselves (least-violating wins when nothing fits).
_INFEASIBLE = 1e12


class Objective:
    """Base: scalarize a PerfEntry; lower is better."""

    name = "objective"

    def cost(self, entry) -> float:
        raise NotImplementedError

    def feasible(self, entry) -> bool:
        """Whether the entry satisfies this objective's hard constraints."""
        return self.cost(entry) < _INFEASIBLE

    def _params(self) -> Tuple:
        return ()

    def cache_key(self) -> Tuple:
        return (type(self).__name__,) + self._params()

    # string back-compat: EnergyObjective() == "energy" etc.  Hashing by
    # name keeps dict/set lookups with string keys working too (equal
    # objects must hash equal; same-name objectives merely collide).
    def __eq__(self, other):
        if isinstance(other, str):
            return other == self.name
        return (type(other) is type(self)
                and other._params() == self._params())

    def __hash__(self):
        return hash(self.name)

    def __repr__(self):
        args = ", ".join(f"{v!r}" for v in self._params())
        return f"{type(self).__name__}({args})"


class LatencyObjective(Objective):
    """Minimize per-sample latency (the paper's default)."""
    name = "latency"

    def cost(self, entry) -> float:
        return entry.per_sample_ms


class EnergyObjective(Objective):
    """Minimize per-sample energy."""
    name = "energy"

    def cost(self, entry) -> float:
        return entry.per_sample_j


class WeightedObjective(Objective):
    """``latency_weight·ms/sample + energy_weight·J/sample`` — the weights
    absorb the unit conversion (e.g. J→ms-equivalents)."""
    name = "weighted"

    def __init__(self, latency_weight: float = 1.0,
                 energy_weight: float = 0.0):
        if latency_weight < 0 or energy_weight < 0:
            raise ValueError("objective weights must be non-negative")
        if latency_weight == 0 and energy_weight == 0:
            raise ValueError("at least one objective weight must be > 0")
        self.latency_weight = float(latency_weight)
        self.energy_weight = float(energy_weight)

    def cost(self, entry) -> float:
        return (self.latency_weight * entry.per_sample_ms
                + self.energy_weight * entry.per_sample_j)

    def _params(self) -> Tuple:
        return (self.latency_weight, self.energy_weight)


class SLOObjective(Objective):
    """Constrained objective: minimize ``base`` (default energy) subject to
    per-sample latency ≤ ``max_latency_ms``.  When no candidate meets the
    SLO the least-violating (fastest) one is chosen, and
    ``feasible(entry)`` reports False for it.
    """
    name = "slo"

    def __init__(self, max_latency_ms: float,
                 base: Union[str, Objective] = "energy"):
        if max_latency_ms <= 0:
            raise ValueError("max_latency_ms must be positive")
        self.max_latency_ms = float(max_latency_ms)
        self.base = resolve_objective(base)

    def cost(self, entry) -> float:
        if entry.per_sample_ms > self.max_latency_ms:
            return _INFEASIBLE + entry.per_sample_ms
        return self.base.cost(entry)

    def _params(self) -> Tuple:
        return (self.max_latency_ms, self.base.cache_key())

    def __repr__(self):
        return (f"SLOObjective(max_latency_ms={self.max_latency_ms:g}, "
                f"base={self.base!r})")


ObjectiveLike = Union[str, Objective]

_STRING_OBJECTIVES = {
    "latency": LatencyObjective,
    "energy": EnergyObjective,
}


def resolve_objective(obj: ObjectiveLike) -> Objective:
    """Accept an Objective instance or a legacy string spelling."""
    if isinstance(obj, Objective):
        return obj
    if isinstance(obj, str):
        try:
            return _STRING_OBJECTIVES[obj]()
        except KeyError:
            raise ValueError(
                f"unknown objective {obj!r}; string spellings are "
                f"{sorted(_STRING_OBJECTIVES)} — or pass an Objective "
                "instance (WeightedObjective, SLOObjective, ...)") from None
    raise TypeError(f"objective must be a string or Objective, "
                    f"got {type(obj).__name__}")
