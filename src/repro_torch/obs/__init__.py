"""repro_torch.obs — observability for the port.

* :mod:`repro_torch.obs.metrics` — the typed counter/gauge/histogram
  registry behind the session's gauges and every ``stats_snapshot()``.
* :mod:`repro_torch.obs.trace` — span tracing (deterministic span ids,
  explicit timestamps) that the serving runtime emits per request.

The exporters (JSONL span files, Prometheus text, the stage-breakdown
line) are not ported yet (ROADMAP queue 1 item 10).
"""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      PROVENANCES, StatsDict)
from .trace import (STAGES, Span, Tracer, breakdown, build_tree,
                    maybe_span, request_breakdown, request_trace_id,
                    span_from_dict, span_to_dict, tree_lines)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "PROVENANCES", "StatsDict", "STAGES", "Span", "Tracer",
           "breakdown", "build_tree", "maybe_span", "request_breakdown",
           "request_trace_id", "span_from_dict", "span_to_dict",
           "tree_lines"]
