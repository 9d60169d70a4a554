"""Typed metrics registry unifying the stack's telemetry counters.

Before this module each tier kept its own mutable ``self.stats`` dict
with ad-hoc keys and four divergent ``stats_snapshot()`` shapes
(``ServingRuntime``, ``FleetRouter``, ``SimWorker``, ``RpcWorker``).
Now every scalar lives in a :class:`MetricsRegistry` under one naming
scheme, and the old dicts survive as :class:`StatsDict` — a
``MutableMapping`` whose scalar entries are registry-backed, so code
like ``self.stats["retries"] += 1`` and every existing
``stats_snapshot()`` consumer keep working unchanged.

Naming scheme (documented in ``docs/api.md`` → Observability):

    <tier>.<metric>               e.g. serving.steps, fleet.router.routed
    <tier>.<metric>{label=value}  e.g. rpc.client.frames_in{worker="w0"}

* tiers: ``serving``, ``fleet.router``, ``fleet.worker``,
  ``rpc.client``, ``rpc.server``, ``session``, ``link``, ``codec``
* counters are monotonic event counts; gauges are last-value
  observations and may carry a ``provenance`` label
  (``modeled|estimated|measured``) — the bandwidth-unit fix routes both
  :meth:`~repro_torch.utils.bandwidth.BandwidthEstimator.observe_transfer`
  (link Mbps) and codec calibration (decode bytes/s) through
  provenance-labelled gauges instead of per-file boolean flags;
* histograms keep a bounded, deterministic value buffer and expose
  streaming ``p50``/``p99``.

The Prometheus-style text dump lives in :mod:`repro_torch.obs.export`.
"""
from __future__ import annotations

import bisect
from typing import Dict, Iterator, List, MutableMapping, Optional, Tuple

#: Allowed values of the ``provenance`` label on bandwidth-ish gauges.
PROVENANCES = ("modeled", "estimated", "measured")

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, str]]) -> LabelKey:
    return tuple(sorted((str(k), str(v))
                        for k, v in (labels or {}).items()))


def format_name(name: str, labels: LabelKey) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class Metric:
    """Base: a named, labelled scalar (or distribution)."""

    typ = "untyped"

    def __init__(self, name: str, labels: LabelKey, help: str = ""):
        self.name, self.labels, self.help = name, labels, help

    @property
    def full_name(self) -> str:
        return format_name(self.name, self.labels)


class Counter(Metric):
    """Monotonic event count.  ``set`` exists only so :class:`StatsDict`
    can initialise/reset compatibility entries; instrumentation should
    use ``inc``."""

    typ = "counter"

    def __init__(self, name, labels, help=""):
        super().__init__(name, labels, help)
        self.value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def set(self, v: float) -> None:
        self.value = float(v)


class Gauge(Metric):
    """Last-value observation (queue depth, bandwidth, occupancy)."""

    typ = "gauge"

    def __init__(self, name, labels, help=""):
        super().__init__(name, labels, help)
        self.value: float = 0.0
        self.observations: int = 0

    def set(self, v: float) -> None:
        self.value = float(v)
        self.observations += 1


class Histogram(Metric):
    """Value distribution with streaming quantiles.

    Keeps a sorted buffer capped at ``max_samples``; past the cap, every
    second retained sample is dropped (deterministic decimation — no
    RNG, so virtual-clock runs stay reproducible) while ``count``/
    ``sum`` keep exact totals.  Quantiles interpolate over the buffer.
    """

    typ = "histogram"

    def __init__(self, name, labels, help="", max_samples: int = 4096):
        super().__init__(name, labels, help)
        self.count = 0
        self.sum = 0.0
        self.max_samples = max_samples
        self._vals: List[float] = []

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        bisect.insort(self._vals, v)
        if len(self._vals) > self.max_samples:
            del self._vals[::2]

    def percentile(self, p: float) -> float:
        """p in [0, 100]; 0.0 when empty."""
        if not self._vals:
            return 0.0
        if len(self._vals) == 1:
            return self._vals[0]
        rank = (p / 100.0) * (len(self._vals) - 1)
        lo = int(rank)
        hi = min(lo + 1, len(self._vals) - 1)
        frac = rank - lo
        return self._vals[lo] * (1 - frac) + self._vals[hi] * frac

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p99(self) -> float:
        return self.percentile(99)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """Flat registry of typed metrics keyed by ``(name, labels)``.

    ``counter``/``gauge``/``histogram`` get-or-create (type mismatch on
    an existing name is an error — one name, one type).  ``snapshot()``
    returns ``{formatted_name: value}`` for counters/gauges plus
    ``.../count|sum|p50|p99`` entries per histogram.
    """

    def __init__(self):
        self._metrics: Dict[Tuple[str, LabelKey], Metric] = {}

    def _get(self, cls, name: str, labels=None, help: str = "", **kw):
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, key[1], help=help, **kw)
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.typ}, requested {cls.typ}")
        return m

    def counter(self, name: str, labels: Optional[Dict[str, str]] = None,
                help: str = "") -> Counter:
        return self._get(Counter, name, labels, help)

    def gauge(self, name: str, labels: Optional[Dict[str, str]] = None,
              help: str = "") -> Gauge:
        return self._get(Gauge, name, labels, help)

    def histogram(self, name: str, labels: Optional[Dict[str, str]] = None,
                  help: str = "", max_samples: int = 4096) -> Histogram:
        return self._get(Histogram, name, labels, help,
                         max_samples=max_samples)

    def observe_bandwidth(self, name: str, value: float, provenance: str,
                          **labels: str) -> Gauge:
        """The one gauge both link- and codec-bandwidth call sites route
        through: value + explicit provenance label, no boolean flags.
        Units live in the metric name (``..._mbps``, ``..._bytes_per_s``).
        """
        if provenance not in PROVENANCES:
            raise ValueError(f"provenance must be one of {PROVENANCES}, "
                             f"got {provenance!r}")
        g = self.gauge(name, {**labels, "provenance": provenance})
        g.set(value)
        return g

    def metrics(self) -> List[Metric]:
        return [self._metrics[k] for k in sorted(self._metrics)]

    def find(self, name: str) -> List[Metric]:
        return [m for m in self.metrics() if m.name == name]

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for m in self.metrics():
            if isinstance(m, Histogram):
                out[m.full_name + "/count"] = m.count
                out[m.full_name + "/sum"] = m.sum
                out[m.full_name + "/p50"] = m.p50
                out[m.full_name + "/p99"] = m.p99
            else:
                out[m.full_name] = m.value
        return out


class StatsDict(MutableMapping):
    """Dict-compatible stats whose scalar entries live in a registry.

    The compatibility shim for the four legacy ``stats`` dicts: reads,
    writes, ``+=``, ``dict(...)`` copies and iteration behave exactly
    like the plain dict they replace, but every scalar entry is backed
    by a registry :class:`Counter` named ``<prefix>.<key>`` (with the
    component's labels, e.g. ``worker="edge-a"``), so one Prometheus
    dump sees every tier under the unified scheme.  Non-scalar entries
    (e.g. the router's ``rejections`` reason-dict) stay plain objects.
    """

    def __init__(self, registry: MetricsRegistry, prefix: str,
                 initial: Optional[Dict[str, object]] = None,
                 labels: Optional[Dict[str, str]] = None):
        self.registry = registry
        self.prefix = prefix
        self.labels = dict(labels or {})
        self._order: List[str] = []
        self._plain: Dict[str, object] = {}
        for k, v in (initial or {}).items():
            self[k] = v

    def _metric(self, key: str) -> Counter:
        return self.registry.counter(f"{self.prefix}.{key}", self.labels)

    def __getitem__(self, key: str):
        if key not in self._order:
            raise KeyError(key)
        if key in self._plain:
            return self._plain[key]
        v = self._metric(key).value
        return int(v) if v == int(v) else v

    def __setitem__(self, key: str, value) -> None:
        if key not in self._order:
            self._order.append(key)
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            self._plain[key] = value
            return
        self._plain.pop(key, None)
        self._metric(key).set(value)

    def __delitem__(self, key: str) -> None:
        if key not in self._order:
            raise KeyError(key)
        self._order.remove(key)
        self._plain.pop(key, None)

    def __iter__(self) -> Iterator[str]:
        return iter(list(self._order))

    def __len__(self) -> int:
        return len(self._order)

    def __repr__(self) -> str:
        return f"StatsDict({dict(self)!r})"
