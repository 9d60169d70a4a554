"""Shared EWMA bandwidth estimator + deterministic drift model.

The paper's runtime probes the link and alpha-blends observations into a
running estimate the policy queries.  The blend used to be duplicated in
``AdaptiveDispatcher.observe_bandwidth`` and ``InferenceSession`` (same
formula, two drifting copies); :class:`BandwidthEstimator` is now the one
implementation both consume — and the serving scheduler reads it too.

:class:`BandwidthWalk` is the drift side of the same story: a seeded,
replayable bandwidth-over-time curve (linear ramp + bounded jitter) that
the chaos layer scripts into fault schedules — WiFi links drift, and the
scenario suite must drift them *identically* on every run.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BandwidthEstimator:
    """EWMA link-bandwidth estimate: ``bw ← α·obs + (1-α)·bw``.

    With a ``metrics`` registry attached, every observation also lands in
    the ``link.bandwidth_mbps`` gauge with an explicit provenance label:
    probe observations are ``estimated`` (someone's external estimate of
    the link), transfer-derived ones are ``measured`` (bytes actually
    moved over a measured wall), and ``reset`` pins are ``modeled``.
    This replaces the old per-call-site unit/provenance ambiguity — the
    label, not the file a number landed in, says where it came from.
    """

    initial_mbps: float = 400.0
    alpha: float = 0.3
    metrics: object = None             # Optional[MetricsRegistry]

    def __post_init__(self):
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {self.alpha}")
        self._mbps = float(self.initial_mbps)
        self._n = 0

    def _gauge(self, obs_mbps: float, provenance: str) -> None:
        if self.metrics is not None:
            self.metrics.observe_bandwidth("link.bandwidth_mbps", obs_mbps,
                                           provenance)
            self.metrics.gauge("link.bandwidth_ewma_mbps").set(self._mbps)

    def observe(self, mbps: float, provenance: str = "estimated") -> float:
        """Fold one observation in; returns the updated estimate."""
        self._mbps = self.alpha * float(mbps) + (1 - self.alpha) * self._mbps
        self._n += 1
        self._gauge(float(mbps), provenance)
        return self._mbps

    def observe_transfer(self, n_bytes: float, wall_ms: float) -> float:
        """Fold one *observed transfer* in: ``n_bytes`` moved in
        ``wall_ms`` implies a link bandwidth, EWMA-blended like a probe.
        This is how ``session.calibrate()`` refines the link estimate from
        per-dispatch bytes-on-wire telemetry; returns the implied Mbps."""
        if n_bytes <= 0 or wall_ms <= 0:
            raise ValueError(f"transfer needs positive bytes and wall "
                             f"(got {n_bytes} B / {wall_ms} ms)")
        mbps = n_bytes * 8e-3 / wall_ms        # bytes/ms → Mbit/s
        self.observe(mbps, provenance="measured")
        return mbps

    def reset(self, mbps: float) -> None:
        """Pin the estimate (e.g. a fresh probe after a re-mesh)."""
        self._mbps = float(mbps)
        self._gauge(float(mbps), "modeled")

    @property
    def mbps(self) -> float:
        return self._mbps

    @property
    def observations(self) -> int:
        return self._n


@dataclasses.dataclass
class BandwidthWalk:
    """Seeded bandwidth-over-time curve for drift injection.

    ``at(u)`` (``u`` ∈ [0, 1], fraction of the drift window) returns the
    linear ramp from ``from_mbps`` to ``to_mbps`` perturbed by a bounded,
    seed-deterministic jitter — the same seed always produces the same
    curve, which is what makes a chaos schedule replayable.
    """

    from_mbps: float
    to_mbps: float
    seed: int = 0
    jitter: float = 0.1            # max relative perturbation
    resolution: int = 64           # jitter sample points over [0, 1]

    def __post_init__(self):
        if self.from_mbps <= 0 or self.to_mbps <= 0:
            raise ValueError("bandwidth endpoints must be > 0")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")
        rng = np.random.RandomState(self.seed)
        self._noise = rng.uniform(-1.0, 1.0, max(self.resolution, 2))

    def at(self, u: float) -> float:
        """Bandwidth (Mbps) at fraction ``u`` of the drift window."""
        u = min(max(float(u), 0.0), 1.0)
        base = self.from_mbps + (self.to_mbps - self.from_mbps) * u
        x = u * (len(self._noise) - 1)
        i = int(x)
        j = min(i + 1, len(self._noise) - 1)
        noise = self._noise[i] + (self._noise[j] - self._noise[i]) * (x - i)
        return max(base * (1.0 + self.jitter * noise), 1e-3)

    def sample(self, n: int):
        """``n`` evenly-spaced values over the window (drift events)."""
        return [self.at((i + 1) / n) for i in range(n)]
