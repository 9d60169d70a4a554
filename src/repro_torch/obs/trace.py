"""Structured span tracing across the whole stack.

A copy of ``repro.obs.trace``: the port's serving runtime, fleet router
and RPC workers emit these spans, and ``repro_torch.obs.export`` writes
them out.

One request touches five tiers — session, serving runtime, paged pool,
fleet router, RPC subprocess worker — and the paper's central finding
(CPU–GPU *staging* during communication, not raw wire bandwidth,
dominates Jetson-class latency; arXiv 2605.25682 Table 2) was only
discoverable because wall time could be attributed to *stages*.  This
module provides that attribution: a :class:`Tracer` emits
:class:`Span` records with ``trace_id``/``span_id``/``parent_id``
forming one tree per request, tagged with a stage from the fixed
taxonomy (:data:`STAGES`).

Two properties matter more than OpenTelemetry parity:

* **Deterministic on the virtual clock.**  Span ids are per-tracer
  counters (``"<tracer-name>:<n>"``), never random, and every
  ``start``/``record`` call accepts explicit timestamps so virtual-time
  drivers (``FleetRouter.drive_virtual``, ``SimWorker``) stamp spans
  with simulated time.  Same chaos seed → byte-identical span tree, so
  CI can assert on trace *structure* (see
  ``tests/test_obs.py::test_chaos_trace_deterministic``).
* **Cheap when disabled.**  Every instrumentation site guards on
  ``tracer is None``; attaching a tracer is opt-in
  (``--trace``/``--metrics`` on the launchers, or
  ``runtime.tracer = Tracer()``).

Spans from a subprocess worker are serialized with :func:`span_to_dict`,
shipped back on ``CompletionMsg``/``TokenChunk`` header fields, and
re-attached to the client tracer with :meth:`Tracer.ingest` — the
worker's root ``request`` span carries the client's dispatch span id as
``parent_id`` (propagated via ``SubmitRequest.trace_id`` /
``.parent_span``), so the merged tree is a single request tree that
crosses the process boundary.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence

#: The stage taxonomy (fixed; new stages need a doc + breakdown review).
#: Maps onto the paper's Table-2 decomposition: ``staging`` + ``wire`` +
#: ``codec_decode`` are the communication stages of a staged link,
#: ``prefill``/``decode``/``decode_chunk`` are compute, the rest are
#: serving/fleet control plane.
STAGES = (
    "queue_wait",     # arrival -> admission into a slot/page pool
    "prefill",        # prompt pass priming a slot (prime_slot)
    "admit",          # KV install + slot bookkeeping (admit_slot)
    "decode",         # admission -> completion residency of one request
    "decode_chunk",   # one continuous-batching chunk (all active rows)
    "codec_encode",   # exchange-codec encode (client->wire)
    "codec_decode",   # exchange-codec decode (wire->device)
    "staging",        # host<->device copy of a staged link (modeled)
    "wire",           # bytes on the link (RPC frame I/O, or modeled)
    "retry",          # re-submit / re-route of an owned request
    "failover",       # drain + re-route after a dead worker
)

#: Control-plane span names that are not stages but appear as tree nodes.
SPAN_KINDS = ("session", "serving", "fleet", "rpc", "transport")


def request_trace_id(req_id) -> str:
    """Canonical trace id for a serving request — stable across process
    boundaries and across kill -> retry -> re-serve (the request id is
    the exactly-once key, so it is the trace key too)."""
    return f"req:{req_id}"


@dataclasses.dataclass
class Span:
    """One timed node of a request tree.

    ``start``/``end`` are seconds on the owning tracer's clock (wall
    monotonic or virtual sim-time); ``end`` is NaN while open.  ``attrs``
    holds small JSON-safe scalars only — spans cross the RPC wire.
    """
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    name: str                     # a STAGES entry or a control-plane name
    kind: str                     # SPAN_KINDS entry
    worker: str = ""
    start: float = 0.0
    end: float = float("nan")
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def duration_ms(self) -> float:
        return 1e3 * (self.end - self.start)

    @property
    def open(self) -> bool:
        return self.end != self.end      # NaN check without math import


def span_to_dict(sp: Span) -> Dict[str, object]:
    """JSON-safe encoding (wire format + JSONL exporter row)."""
    return {
        "trace_id": sp.trace_id, "span_id": sp.span_id,
        "parent_id": sp.parent_id, "name": sp.name, "kind": sp.kind,
        "worker": sp.worker, "start": sp.start, "end": sp.end,
        "attrs": dict(sp.attrs),
    }


def span_from_dict(doc: Dict[str, object]) -> Span:
    return Span(trace_id=str(doc["trace_id"]), span_id=str(doc["span_id"]),
                parent_id=doc.get("parent_id"), name=str(doc["name"]),
                kind=str(doc.get("kind", "")),
                worker=str(doc.get("worker", "")),
                start=float(doc.get("start", 0.0)),
                end=float(doc.get("end", float("nan"))),
                attrs=dict(doc.get("attrs", {})))


class _ActiveCtx:
    """``with tracer.active(span):`` — pushes a parent for nested spans."""

    def __init__(self, tracer: "Tracer", span: Optional[Span]):
        self._tracer, self._span = tracer, span

    def __enter__(self):
        self._tracer._stack.append(self._span)
        return self._span

    def __exit__(self, *exc):
        self._tracer._stack.pop()
        return False


class _SpanCtx:
    """``with tracer.span(...) as sp:`` — starts, parents, finishes."""

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer, self.span = tracer, span

    def __enter__(self):
        self._tracer._stack.append(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb):
        self._tracer._stack.pop()
        if exc_type is not None:
            self.span.attrs.setdefault("error", exc_type.__name__)
        self._tracer.finish(self.span)
        return False


class Tracer:
    """Span factory + buffer for one process (or one virtual fleet).

    ``name`` namespaces span ids (``"<name>:<counter>"``) so spans from
    different processes never collide when merged client-side.  ``clock``
    is any ``() -> float`` — ``time.monotonic`` by default; virtual-time
    drivers either inject their clock or pass explicit ``at=``/``start=``
    /``end=`` stamps, which always win over the clock.
    """

    def __init__(self, name: str = "main",
                 clock: Optional[Callable[[], float]] = None):
        self.name = name
        self.clock = clock or time.monotonic
        self.spans: List[Span] = []
        self._ids = itertools.count(1)
        self._stack: List[Optional[Span]] = []
        self._seen: set = set()          # (trace_id, span_id) of ingested

    # ---- creation ----------------------------------------------------
    def _next_id(self) -> str:
        return f"{self.name}:{next(self._ids)}"

    def current(self) -> Optional[Span]:
        """Innermost active span (or None)."""
        for sp in reversed(self._stack):
            if sp is not None:
                return sp
        return None

    def start(self, name: str, *, kind: str = "serving",
              trace_id: Optional[str] = None,
              parent_id: Optional[str] = None, worker: str = "",
              at: Optional[float] = None, **attrs) -> Span:
        """Open a span.  Parent defaults to the active span's id; trace
        defaults to the active span's trace (or a fresh one-off trace)."""
        cur = self.current()
        if parent_id is None and cur is not None:
            parent_id = cur.span_id
        if trace_id is None:
            trace_id = cur.trace_id if cur is not None else self._next_id()
        sp = Span(trace_id=trace_id, span_id=self._next_id(),
                  parent_id=parent_id, name=name, kind=kind, worker=worker,
                  start=self.clock() if at is None else at, attrs=attrs)
        self.spans.append(sp)
        return sp

    def finish(self, span: Span, *, at: Optional[float] = None) -> Span:
        span.end = self.clock() if at is None else at
        return span

    def record(self, name: str, *, start: float, end: float,
               kind: str = "serving", trace_id: Optional[str] = None,
               parent_id: Optional[str] = None, worker: str = "",
               **attrs) -> Span:
        """One-shot closed span with explicit timestamps (virtual-clock
        drivers and post-hoc attribution)."""
        sp = self.start(name, kind=kind, trace_id=trace_id,
                        parent_id=parent_id, worker=worker, at=start,
                        **attrs)
        sp.end = end
        return sp

    def span(self, name: str, **kw) -> _SpanCtx:
        """Context manager: start on enter, finish on exit, and act as
        the parent of spans opened inside the block."""
        return _SpanCtx(self, self.start(name, **kw))

    def active(self, span: Optional[Span]) -> _ActiveCtx:
        """Make ``span`` the parent for spans opened inside the block
        without owning its lifetime (it stays open on exit)."""
        return _ActiveCtx(self, span)

    # ---- cross-process merge -----------------------------------------
    def ingest(self, docs: Iterable[Dict[str, object]]) -> int:
        """Attach foreign spans (a subprocess worker's, shipped back on
        ``CompletionMsg``/``TokenChunk``).  Foreign span ids carry their
        own tracer namespace so they cannot collide; duplicates (a chunk
        re-shipped after a retry) are dropped by ``(trace, span)`` id."""
        n = 0
        for doc in docs:
            key = (doc.get("trace_id"), doc.get("span_id"))
            if key in self._seen:
                continue
            self._seen.add(key)
            self.spans.append(span_from_dict(doc))
            n += 1
        return n

    # ---- queries ------------------------------------------------------
    def trace(self, trace_id: str) -> List[Span]:
        return [s for s in self.spans if s.trace_id == trace_id]

    def trace_ids(self) -> List[str]:
        out, seen = [], set()
        for s in self.spans:
            if s.trace_id not in seen:
                seen.add(s.trace_id)
                out.append(s.trace_id)
        return out


def maybe_span(tracer: Optional[Tracer], name: str, **kw):
    """``with maybe_span(self.tracer, "prefill", ...):`` — the guard every
    instrumentation site uses so tracing-off costs one None check."""
    if tracer is None:
        return contextlib.nullcontext()
    return tracer.span(name, **kw)


# ---- tree + breakdown -----------------------------------------------


def build_tree(spans: Sequence[Span]) -> Dict[Optional[str], List[Span]]:
    """children-by-parent-id index, children in start order (ties broken
    by span id so virtual-clock trees are stable)."""
    tree: Dict[Optional[str], List[Span]] = {}
    ids = {s.span_id for s in spans}
    for s in spans:
        # a parent outside this span set (e.g. filtering one trace out of
        # a shared tracer) makes the span a root of the local view
        parent = s.parent_id if s.parent_id in ids else None
        tree.setdefault(parent, []).append(s)
    for kids in tree.values():
        kids.sort(key=lambda s: (s.start, s.span_id))
    return tree


def tree_lines(spans: Sequence[Span]) -> List[str]:
    """Canonical ASCII rendering of a span forest — the determinism
    artifact two seeded chaos runs are compared on, byte for byte."""
    tree = build_tree(spans)
    out: List[str] = []

    def walk(parent: Optional[str], depth: int):
        for sp in tree.get(parent, []):
            dur = ("open" if sp.open else f"{sp.duration_ms:.3f}ms")
            attrs = "".join(f" {k}={sp.attrs[k]}" for k in sorted(sp.attrs))
            out.append(f"{'  ' * depth}{sp.name} [{sp.kind}"
                       f"{'/' + sp.worker if sp.worker else ''}] "
                       f"{dur}{attrs}")
            walk(sp.span_id, depth + 1)

    walk(None, 0)
    return out


def breakdown(spans: Sequence[Span],
              stages: Sequence[str] = STAGES) -> Dict[str, float]:
    """Table-2-style stage decomposition: total milliseconds per stage
    over the *leaf* spans of the given set (non-leaf spans like a
    request's ``decode`` residency contain their children's time and
    would double-count).  Returns ``{stage: total_ms}`` for stages that
    appear, in taxonomy order.
    """
    has_child = {s.parent_id for s in spans if s.parent_id is not None}
    totals: Dict[str, float] = {}
    for s in spans:
        if s.open or s.span_id in has_child or s.name not in stages:
            continue
        totals[s.name] = totals.get(s.name, 0.0) + s.duration_ms
    return {st: totals[st] for st in stages if st in totals}


def request_breakdown(spans: Sequence[Span], trace_id: str
                      ) -> Dict[str, float]:
    """Per-request stage decomposition for one trace.  The leaf stages
    of a request tree partition its wall time (queue_wait + prefill +
    admit + decode ≈ finished − arrival), so ``sum(values)`` reconciles
    with the request's measured latency — the BENCH_trace gate asserts
    this within 10%."""
    return breakdown([s for s in spans if s.trace_id == trace_id])
