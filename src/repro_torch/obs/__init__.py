"""repro_torch.obs — observability for the port.

* :mod:`repro_torch.obs.metrics` — the typed counter/gauge/histogram
  registry behind the session's gauges and every ``stats_snapshot()``.
* :mod:`repro_torch.obs.trace` — span tracing (deterministic span ids,
  explicit timestamps) that the serving runtime, the fleet router and the
  RPC workers emit per request, with cross-process trace propagation.
* :mod:`repro_torch.obs.export` — JSONL span files, Prometheus text
  dumps, and the Table-2-style stage-breakdown line.
"""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      PROVENANCES, StatsDict)
from .trace import (STAGES, Span, Tracer, breakdown, build_tree,
                    maybe_span, request_breakdown, request_trace_id,
                    span_from_dict, span_to_dict, tree_lines)
from .export import (format_breakdown, prometheus_text, read_spans_jsonl,
                     write_spans_jsonl)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "PROVENANCES", "StatsDict", "STAGES", "Span", "Tracer",
           "breakdown", "build_tree", "maybe_span", "request_breakdown",
           "request_trace_id", "span_from_dict", "span_to_dict",
           "tree_lines", "format_breakdown", "prometheus_text",
           "read_spans_jsonl", "write_spans_jsonl"]
