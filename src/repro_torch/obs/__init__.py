"""repro_torch.obs — the metrics registry behind the session's gauges.

Span tracing and the exporters come with the serving slice.
"""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      PROVENANCES, StatsDict)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "PROVENANCES", "StatsDict"]
