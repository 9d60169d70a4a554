"""Exporters: JSONL span files, Prometheus-style text, breakdown lines.

Three consumers, three formats:

* ``--trace out.jsonl`` on the launchers → :func:`write_spans_jsonl`
  (one :func:`~repro_torch.obs.trace.span_to_dict` row per line; reload with
  :func:`read_spans_jsonl` for offline analysis or
  ``calibrate(records=from_trace(...))``).
* ``--metrics`` → :func:`prometheus_text` — a Prometheus exposition
  dump of every registry metric (dots become underscores; histograms
  expand to ``_count``/``_sum``/``_p50``/``_p99`` samples).
* the per-stage breakdown line both launchers print at exit →
  :func:`format_breakdown`, the Table-2-style stage decomposition from
  :func:`repro_torch.obs.trace.breakdown`.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence

from .metrics import Histogram, MetricsRegistry
from .trace import Span, breakdown, span_from_dict, span_to_dict


def write_spans_jsonl(spans: Iterable[Span], path: str) -> int:
    """One JSON object per line; returns the number of rows written.
    Sorted by (trace, start, span id) so the file is diffable across
    deterministic runs."""
    rows = sorted(spans, key=lambda s: (s.trace_id, s.start, s.span_id))
    with open(path, "w") as fh:
        for sp in rows:
            fh.write(json.dumps(span_to_dict(sp), sort_keys=True) + "\n")
    return len(rows)


def read_spans_jsonl(path: str) -> List[Span]:
    out: List[Span] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(span_from_dict(json.loads(line)))
    return out


def _prom_name(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def _prom_labels(labels) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{_prom_name(k)}="{v}"'
                          for k, v in labels) + "}"


def prometheus_text(*registries: MetricsRegistry) -> str:
    """Prometheus exposition format (text/plain; version 0.0.4-ish).
    Accepts several registries (client + per-worker) and merges them
    into one dump; duplicate full names keep the last value seen."""
    by_name: Dict[str, List] = {}
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    for reg in registries:
        for m in reg.metrics():
            n = _prom_name(m.name)
            by_name.setdefault(n, []).append(m)
            types[n] = "gauge" if m.typ == "gauge" else "counter" \
                if m.typ == "counter" else "histogram"
            if m.help:
                helps[n] = m.help
    lines: List[str] = []
    for n in sorted(by_name):
        if n in helps:
            lines.append(f"# HELP {n} {helps[n]}")
        lines.append(f"# TYPE {n} {types[n]}")
        for m in by_name[n]:
            lab = _prom_labels(m.labels)
            if isinstance(m, Histogram):
                lines.append(f"{n}_count{lab} {m.count}")
                lines.append(f"{n}_sum{lab} {m.sum:g}")
                lines.append(f"{n}_p50{lab} {m.p50:g}")
                lines.append(f"{n}_p99{lab} {m.p99:g}")
            else:
                lines.append(f"{n}{lab} {m.value:g}")
    return "\n".join(lines) + "\n"


def format_breakdown(spans: Sequence[Span],
                     wall_ms: Optional[float] = None) -> str:
    """The one-line stage decomposition both launchers print at exit:

        stages: queue_wait 1.2ms | prefill 40.3ms | ... (Σ 97% of wall)

    ``wall_ms`` (total measured request wall time, summed over
    requests) adds the reconciliation percentage."""
    bd = breakdown(spans)
    if not bd:
        return "stages: (no closed spans)"
    parts = [f"{k} {v:.1f}ms" for k, v in bd.items()]
    line = "stages: " + " | ".join(parts)
    total = sum(bd.values())
    if wall_ms:
        line += f"  (Σ {total:.1f}ms = {100.0 * total / wall_ms:.0f}% of " \
                f"{wall_ms:.1f}ms wall)"
    else:
        line += f"  (Σ {total:.1f}ms)"
    return line
