"""Fleet router: policy-table-scored placement over a device registry.

The paper's profiling doctrine, one level up: the same compiled
:class:`~repro_torch.profiling.table.PolicyTable` that picks an execution mode
*within* a session here picks the *worker* — for each live worker the
router asks its table what serving one more request would cost at that
worker's hardware and current bandwidth, inflates the answer by queue
pressure, and admits the request to the cheapest worker's bounded EDF
queue.  Every decision is recorded as a :class:`PlacementRecord` whose
``explain()`` prints the full scored ranking — placement is auditable, not
a heuristic.

Failure semantics (same shape as the in-session fault path, PR 4): a
heartbeat miss surfaces through ``registry.check_dead()`` exactly once;
the router drains the dead worker's queued *and* in-flight requests and
re-routes them (``force=True`` — admitted work is never shed by the
bound).  A re-served request restarts from scratch on the new worker and
is token-exact with ``session.generate`` because ``seed``/``temperature``
pin the sampling chain; EDF order is recovered by the target queue's
deadline-ordered ``pop``.

Backpressure: when a pinned worker's queue is full, or every live
worker's queue is full, ``route`` raises :class:`FleetRejected` with a
machine-readable ``reason`` — and the shed is counted in the router stats
and in the per-worker queue's ``rejections`` (satellite: rejection is
telemetry, not a silent exception).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.policy import resolve_objective
from repro_torch.fleet.registry import DeviceRegistry, Worker
from repro_torch.obs import MetricsRegistry, StatsDict, request_trace_id
from repro_torch.runtime.fault import CircuitBreaker, RetryPolicy
from repro_torch.serving.queue import QueueFull, Request
from repro_torch.serving.scheduler import FailoverEvent

# FleetRejected reasons a placement retry can cure (queue pressure and
# breaker windows pass; a pinned-dead worker does not)
RETRYABLE_REASONS = ("all_full", "no_workers", "breaker_open")


class FleetRejected(RuntimeError):
    """The fleet shed a request.  ``reason``: ``"all_full"`` (every live
    worker's queue at capacity), ``"full"`` (the pinned worker's queue at
    capacity), ``"dead_worker"`` (pinned to a worker that missed its
    heartbeat), ``"no_workers"`` (nothing alive to route to),
    ``"breaker_open"`` (the only candidates are breaker-blocked)."""

    def __init__(self, msg: str, reason: str):
        super().__init__(msg)
        self.reason = reason


@dataclasses.dataclass
class ReadmissionEvent:
    """One revive → re-calibrate → re-profile → re-enter-placement cycle."""
    worker: str
    at: float
    recalibrated: bool = False
    reprofiled: bool = True


@dataclasses.dataclass
class WorkerScore:
    """One worker's placement bid for one request.

    ``score = per_request_cost × (1 + pending / n_slots)``: the policy
    table's objective cost for serving one more request at this worker's
    hardware and bandwidth, inflated by how much work the worker already
    owes relative to its concurrency budget.  ``mode``/``cr``/``codec``
    are the execution decision the table would make there — the placement
    is explainable down to the profiled cell that priced it.
    """
    worker: str
    score: float
    per_request_cost: float        # table objective cost per request
    pending: int                   # queued + in flight at scoring time
    n_slots: int
    queue_depth: int
    bandwidth_mbps: float
    mode: str
    cr: float
    codec: str

    def explain(self) -> str:
        plan = self.mode + (f"@{self.cr:g}" if self.cr else "") \
            + (f"+{self.codec}" if self.codec else "")
        return (f"{self.worker}: score {self.score:.3f} = "
                f"{self.per_request_cost:.3f} (table: {plan} @ "
                f"{self.bandwidth_mbps:g} Mbps) x "
                f"(1 + {self.pending}/{self.n_slots} pending)")


@dataclasses.dataclass
class PlacementRecord:
    """One routing decision: the chosen worker and the full scored field."""
    request_id: int
    worker: str
    scores: List[WorkerScore]              # ranked, cheapest first
    reason: str = "scored"                 # "scored"|"pinned"|"rerouted"

    def explain(self) -> str:
        lines = [f"request {self.request_id} -> {self.worker} "
                 f"({self.reason})"]
        for s in self.scores:
            mark = "->" if s.worker == self.worker else "  "
            lines.append(f"  {mark} {s.explain()}")
        return "\n".join(lines)


class FleetRouter:
    """Front door of the fleet: score, admit, step, fail over.

    ``submit``/``route`` place single requests; ``fanout`` maps a batch of
    prompts across the fleet (map–reduce: ``run``/``drive_virtual`` reduce
    the per-worker completions back into one result set).  ``step`` drives
    real workers on the real clock (auto-beating each worker it
    successfully steps — an explicit ``registry.fail`` still wins, the
    monitor ignores beats from failed nodes); ``drive_virtual`` is the
    event-driven loop for :class:`~repro_torch.fleet.registry.SimWorker` fleets.
    """

    def __init__(self, registry: DeviceRegistry, *, objective=None,
                 retry: Optional[RetryPolicy] = None,
                 breaker_threshold: int = 3, breaker_reset_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic,
                 metrics: Optional[MetricsRegistry] = None, tracer=None):
        self.registry = registry
        self.objective = (resolve_objective(objective)
                          if objective is not None else None)
        self.clock = clock
        # retry=None keeps the pre-chaos semantics: one placement attempt,
        # shed on rejection.  With a RetryPolicy, drive_virtual re-offers
        # rejected arrivals after backoff, within the budget.
        self.retry = retry
        self._breaker_cfg = (breaker_threshold, breaker_reset_s)
        self.breakers: Dict[str, CircuitBreaker] = {}
        self.placements: List[PlacementRecord] = []
        self.events: List = []               # Failover + Readmission events
        # observability: the router shares the registry's metrics registry
        # by default, so one dump covers router + workers + codec gauges
        self.metrics = (metrics if metrics is not None
                        else registry.metrics)
        self.tracer = tracer
        self._trace_roots: Dict[int, object] = {}   # request id → route span
        # virtual drivers stash their clock here so spans recorded inside
        # _check_faults get virtual, deterministic timestamps
        self._now_hint: Optional[float] = None
        self.stats = StatsDict(
            self.metrics, "fleet.router",
            {"routed": 0, "rejected": 0, "rerouted": 0,
             "lost": 0, "fanout": 0, "retries": 0,
             "timeouts": 0, "transport_errors": 0, "gave_up": 0,
             "placement_retries": 0, "breaker_opened": 0,
             "readmitted": 0,
             "rejections": {}})      # shed counts by reason

    def breaker(self, name: str) -> CircuitBreaker:
        """This worker's circuit breaker (created closed on first use)."""
        br = self.breakers.get(name)
        if br is None:
            thresh, reset = self._breaker_cfg
            br = self.breakers[name] = CircuitBreaker(
                fail_threshold=thresh, reset_timeout_s=reset)
        return br

    def attach_tracer(self, tracer) -> None:
        """One tracer for the whole fleet: router placement spans plus
        every registered worker's serving spans land in the same buffer
        (RPC workers additionally merge their subprocess's spans into
        it)."""
        self.tracer = tracer
        for w in self.registry:
            w.tracer = tracer

    # -- scoring -------------------------------------------------------------

    def score_worker(self, w: Worker) -> WorkerScore:
        pending = w.pending
        bp = w.table(self.objective).plan_batch(
            pending + 1, w.bandwidth, max_batch=w.n_slots)
        d = bp.decision
        score = bp.per_request_cost * (1.0 + pending / max(w.n_slots, 1))
        return WorkerScore(worker=w.name, score=score,
                           per_request_cost=bp.per_request_cost,
                           pending=pending, n_slots=w.n_slots,
                           queue_depth=len(w.queue),
                           bandwidth_mbps=w.bandwidth,
                           mode=d.mode, cr=d.cr, codec=d.codec)

    def rank(self, exclude: Sequence[str] = (),
             now: Optional[float] = None) -> List[WorkerScore]:
        """Live, breaker-admitted workers' bids, cheapest first."""
        now = self.clock() if now is None else now
        scores = [self.score_worker(w) for w in self.registry.alive()
                  if w.name not in exclude and self.breaker(w.name).allows(now)]
        return sorted(scores, key=lambda s: (s.score, s.worker))

    # -- admission -----------------------------------------------------------

    def submit(self, prompt, n_new: int, *, pin: Optional[str] = None,
               slo_ms: Optional[float] = None, seed: int = 0,
               temperature: float = 0.0,
               arrival_ts: Optional[float] = None
               ) -> Tuple[Request, PlacementRecord]:
        req = Request(prompt=np.asarray(prompt), n_new=n_new, slo_ms=slo_ms,
                      seed=seed, temperature=temperature,
                      **({} if arrival_ts is None
                         else {"arrival_ts": arrival_ts}))
        return req, self.route(req, pin=pin)

    def route(self, req: Request, *, pin: Optional[str] = None,
              force: bool = False, exclude: Sequence[str] = (),
              reason: str = "scored",
              now: Optional[float] = None) -> PlacementRecord:
        """Admit ``req`` to a worker queue; raises :class:`FleetRejected`
        (with the shed counted) when it cannot.

        ``pin`` bypasses scoring (caller-chosen worker — affinity, tests);
        ``force`` bypasses the queue bound (reserved for re-routing work
        the fleet already admitted); ``exclude`` removes workers from the
        candidate set (e.g. the one that just died).  A worker whose
        circuit breaker is open receives no placements until its reset
        window elapses (the next placement after that is the probe).
        """
        now = self.clock() if now is None else now
        if pin is not None:
            w = self.registry.get(pin)
            if not self.registry.is_alive(pin):
                w.queue.reject("dead_worker")
                return self._shed("dead_worker",
                                  f"worker {pin!r} is dead")
            if not self.breaker(pin).allows(now):
                w.queue.reject("breaker_open")
                return self._shed("breaker_open",
                                  f"worker {pin!r} breaker is open")
            scores = [self.score_worker(w)]
            try:
                w.submit_request(req, force=force)
            except QueueFull as e:
                return self._shed(e.reason,
                                  f"worker {pin!r} queue is full")
            rec = PlacementRecord(req.id, pin, scores, reason="pinned")
        else:
            ranked = self.rank(exclude, now=now)
            if not ranked:
                if any(w.name not in exclude for w in self.registry.alive()):
                    return self._shed("breaker_open",
                                      "every live worker is breaker-blocked")
                return self._shed("no_workers", "no live workers")
            placed = None
            for s in ranked:
                try:
                    self.registry.get(s.worker).submit_request(req,
                                                               force=force)
                    placed = s.worker
                    break
                except QueueFull:
                    continue       # that queue counted its own "full"
            if placed is None:
                return self._shed("all_full",
                                  "every live worker queue is at capacity")
            rec = PlacementRecord(req.id, placed, ranked, reason=reason)
        self.placements.append(rec)
        self.stats["routed"] += 1
        if self.tracer is not None:
            self._trace_route(req, rec, now)
        return rec

    def _trace_route(self, req: Request, rec: PlacementRecord,
                     now: float) -> None:
        """First placement opens the request's ``route`` root span and
        hands its id to the worker via ``req.parent_span`` — every
        downstream span (worker-side ``request`` tree, RPC dispatch, a
        subprocess's shipped spans) parents under it, so kill → retry →
        re-serve stays ONE tree.  Re-routes add a ``retry`` leaf."""
        tr = self.tracer
        if not req.trace_id:
            req.trace_id = request_trace_id(req.id)
        root = self._trace_roots.get(req.id)
        if root is None:
            root = tr.start("route", kind="fleet", trace_id=req.trace_id,
                            parent_id=req.parent_span or None,
                            at=req.arrival_ts, worker=rec.worker,
                            reason=rec.reason)
            self._trace_roots[req.id] = root
            req.parent_span = root.span_id
        else:
            req.parent_span = root.span_id
            tr.record("retry", start=now, end=now, kind="fleet",
                      trace_id=req.trace_id, parent_id=root.span_id,
                      worker=rec.worker, reason=rec.reason)
            req.requeued_at = now

    def _shed(self, reason: str, msg: str):
        self.stats["rejected"] += 1
        rej = self.stats["rejections"]
        rej[reason] = rej.get(reason, 0) + 1
        raise FleetRejected(msg, reason=reason)

    def fanout(self, prompts: Sequence, n_new, *, seeds=None,
               slo_ms: Optional[float] = None,
               temperature: float = 0.0
               ) -> List[Tuple[Request, Optional[PlacementRecord]]]:
        """Map a batch of prompts across the fleet (one routing decision
        each; a shed prompt yields ``(req, None)`` instead of aborting the
        batch).  Reduce with ``run()``/``completion_for()``."""
        out = []
        for i, p in enumerate(prompts):
            req = Request(prompt=np.asarray(p),
                          n_new=n_new[i] if not isinstance(n_new, int)
                          else n_new,
                          slo_ms=slo_ms,
                          seed=seeds[i] if seeds is not None else i,
                          temperature=temperature)
            try:
                out.append((req, self.route(req)))
            except FleetRejected:
                out.append((req, None))
        self.stats["fanout"] += 1
        return out

    # -- serving loops -------------------------------------------------------

    def step(self) -> List:
        """One fleet round on the real clock: fault check, then one
        ``ServingRuntime.step`` per live worker (auto-beat on success)."""
        self._check_faults()
        now = self.clock()
        done: List = []
        for w in self.registry.alive():
            done.extend(self._step_worker(w, now))
            # beat on the worker's word: an in-process worker is healthy by
            # construction; an RpcWorker flips `healthy` off when its
            # socket/process is gone, and an explicit fail() routes it into
            # the heartbeat-death drain path the next _check_faults
            if getattr(w, "healthy", True):
                self.registry.beat(w.name)
            else:
                self.registry.fail(w.name)
        return done

    def _step_worker(self, w: Worker, now: float) -> List:
        """Step one worker and feed its dispatch-fault stream into the
        breaker/telemetry (completions are breaker successes)."""
        done = w.step(now)
        for fault in w.pop_faults():
            self._on_fault(w, fault, now)
        if done:
            self.breaker(w.name).record_success(now)
            if self.tracer is not None:
                for c in done:
                    root = self._trace_roots.pop(c.request_id, None)
                    if root is not None:
                        self.tracer.finish(
                            root, at=getattr(c, "finished_ts", now))
        return done

    def _on_fault(self, w: Worker, fault, now: float) -> None:
        """One dispatch failure: count it, trip the breaker if it's the
        threshold-th in a row, and re-place work the worker gave up on."""
        self.stats["retries"] += len(fault.retried)
        self.stats["timeouts" if fault.kind == "timeout"
                   else "transport_errors"] += 1
        if self.breaker(w.name).record_failure(now):
            self.stats["breaker_opened"] += 1
        for req in fault.gave_up:
            self.stats["gave_up"] += 1
            try:
                self.route(req, force=True, exclude=(w.name,),
                           reason="rerouted", now=now)
                self.stats["rerouted"] += 1
            except FleetRejected:
                self.stats["lost"] += 1

    def run(self, max_steps: int = 100_000) -> List:
        """Step until every live worker is drained; returns the completions
        produced (fleet-wide, arbitrary worker interleaving)."""
        done: List = []
        steps = 0
        while True:
            # drain newly-dead workers *before* the exit check: a fleet
            # whose only survivors are idle must still re-route a dead
            # worker's orphans rather than exit and lose them
            self._check_faults()
            if not any(w.queue or not w.idle
                       for w in self.registry.alive()):
                break
            done.extend(self.step())
            steps += 1
            if steps >= max_steps:
                raise RuntimeError(f"run() exceeded {max_steps} steps")
        return done

    def drive_virtual(self, requests: Sequence[Request], *,
                      events: Sequence[Tuple[float, Callable]] = (),
                      max_iters: int = 1_000_000) -> Dict:
        """Event-driven virtual-time loop for ``SimWorker`` fleets.

        ``requests`` carry virtual ``arrival_ts`` (seconds); each is routed
        when the virtual clock reaches it, with the fleet's queue state *at
        that instant* — so placement reflects load, exactly like the real
        loop.  ``events`` are ``(t, fn)`` callbacks (e.g. a
        :meth:`ChaosController.events` schedule, or ``lambda:
        registry.fail("w2")`` to kill a worker mid-run).  When the router
        was built with a :class:`RetryPolicy`, a retryably-rejected arrival
        (queues full, breakers open, fleet momentarily empty) is re-offered
        after exponential backoff instead of shed outright.  Returns the
        drive summary: served completions, shed requests, and the virtual
        makespan.
        """
        pending = sorted(requests, key=lambda r: (r.arrival_ts, r.id))
        evs = sorted(events, key=lambda e: e[0])
        retry_q: List[Tuple[float, int, Request]] = []   # (due, seq, req)
        attempts: Dict[int, int] = {}
        seq = itertools.count()
        shed: List[Request] = []
        done: List = []
        now, iters = 0.0, 0

        def offer(req: Request) -> None:
            try:
                self.route(req, now=now)
            except FleetRejected as e:
                n = attempts.get(req.id, 0)
                if (self.retry is not None
                        and e.reason in RETRYABLE_REASONS
                        and n < self.retry.max_retries):
                    attempts[req.id] = n + 1
                    self.stats["placement_retries"] += 1
                    heapq.heappush(
                        retry_q,
                        (now + self.retry.backoff_s(n), next(seq), req))
                else:
                    shed.append(req)

        while True:
            iters += 1
            if iters > max_iters:
                raise RuntimeError(f"drive_virtual exceeded {max_iters} "
                                   "events")
            next_service = min(
                (w.next_event_at(now) for w in self.registry.alive()),
                default=float("inf"))
            next_arrival = pending[0].arrival_ts if pending else float("inf")
            next_retry = retry_q[0][0] if retry_q else float("inf")
            next_inject = evs[0][0] if evs else float("inf")
            t = min(next_service, next_arrival, next_retry, next_inject)
            if t == float("inf"):
                break
            now = max(now, t)
            self._now_hint = now      # virtual stamps for failover spans
            while evs and evs[0][0] <= now:
                evs.pop(0)[1]()
            self._check_faults()
            while pending and pending[0].arrival_ts <= now:
                offer(pending.pop(0))
            while retry_q and retry_q[0][0] <= now:
                offer(heapq.heappop(retry_q)[2])
            for w in self.registry.alive():
                done.extend(self._step_worker(w, now))
        self._now_hint = None
        shed.extend(req for _, _, req in sorted(retry_q))
        return {"completions": done, "shed": shed, "makespan_s": now,
                "served_tokens": sum(c.n_tokens for c in done)}

    def drive_real(self, requests: Sequence[Request], *,
                   events: Sequence[Tuple[float, Callable]] = (),
                   timeout_s: float = 600.0, poll_s: float = 0.002) -> Dict:
        """Real-clock analog of :meth:`drive_virtual` for process-backed
        fleets (``RpcWorker``/``WorkerHandle``).

        ``requests`` carry *relative* ``arrival_ts`` offsets (seconds from
        drive start); each is rebased to the wall clock and routed when its
        offset elapses.  ``events`` are ``(offset_s, fn)`` callbacks — a
        :meth:`ChaosController.events` schedule realizes kills as actual
        ``SIGKILL`` and errors as actual socket sabotage here.  Rejected
        retryable arrivals re-offer after the router's ``RetryPolicy``
        backoff.  Returns the same summary shape as ``drive_virtual``
        (``served_tokens`` counts real token payloads).
        """
        t0 = self.clock()
        pending = sorted(requests, key=lambda r: (r.arrival_ts, r.id))
        evs = sorted(events, key=lambda e: e[0])
        retry_q: List[Tuple[float, int, Request]] = []   # (due, seq, req)
        attempts: Dict[int, int] = {}
        seq = itertools.count()
        shed: List[Request] = []
        done: List = []

        def offer(req: Request, now: float) -> None:
            try:
                self.route(req)
            except FleetRejected as e:
                n = attempts.get(req.id, 0)
                if (self.retry is not None
                        and e.reason in RETRYABLE_REASONS
                        and n < self.retry.max_retries):
                    attempts[req.id] = n + 1
                    self.stats["placement_retries"] += 1
                    heapq.heappush(
                        retry_q,
                        (now + self.retry.backoff_s(n), next(seq), req))
                else:
                    shed.append(req)

        while True:
            now = self.clock() - t0
            if now > timeout_s:
                raise RuntimeError(f"drive_real exceeded {timeout_s}s with "
                                   f"{len(pending)} arrivals pending")
            while evs and evs[0][0] <= now:
                evs.pop(0)[1]()
            while pending and pending[0].arrival_ts <= now:
                req = pending.pop(0)
                req.arrival_ts = self.clock()    # rebase to the wall clock
                offer(req, now)
            while retry_q and retry_q[0][0] <= now:
                offer(heapq.heappop(retry_q)[2], now)
            self._check_faults()
            done.extend(self.step())
            busy = any(w.queue or not w.idle
                       for w in self.registry.alive())
            if not pending and not evs and not retry_q and not busy \
                    and not self.registry.monitor.dead_nodes():
                break
            if not busy:
                time.sleep(poll_s)
        shed.extend(req for _, _, req in sorted(retry_q))
        return {"completions": done, "shed": shed,
                "makespan_s": self.clock() - t0,
                "served_tokens": sum(len(c.tokens) for c in done)}

    # -- failure semantics ---------------------------------------------------

    def _check_faults(self) -> List[str]:
        """Consume newly-dead workers: drain their queued + in-flight
        requests and re-route each to a surviving worker (``force=True`` —
        admitted work is never shed by the bound), tightest deadline
        first.  A request with nowhere to go is lost and counted."""
        newly = self.registry.check_dead()
        if not newly:
            return []
        now = self._now_hint if self._now_hint is not None else self.clock()
        orphans: List[Request] = []
        for name in newly:
            orphans.extend(self.registry.get(name).drain_requests())
        rerouted = 0
        for req in sorted(orphans, key=lambda r: (r.deadline(),
                                                  r.arrival_ts)):
            try:
                self.route(req, force=True, exclude=newly,
                           reason="rerouted", now=now)
                rerouted += 1
            except FleetRejected:
                self.stats["lost"] += 1
        self.stats["rerouted"] += rerouted
        self.events.append(FailoverEvent(
            dead=list(newly), survivors=len(self.registry.alive()),
            requeued=rerouted))
        if self.tracer is not None:
            self.tracer.record("failover", start=now, end=now, kind="fleet",
                               trace_id="runtime:router",
                               dead=",".join(sorted(newly)),
                               requeued=rerouted)
        return newly

    def readmit(self, name: str, *, now: Optional[float] = None) -> Worker:
        """Re-admit a revived worker: registry-level revive + re-calibrate
        + re-profile (:meth:`DeviceRegistry.readmit`), then reset its
        circuit breaker so placement trusts it again immediately."""
        now = self.clock() if now is None else now
        worker = self.registry.readmit(name)
        self.breaker(name).reset()
        self.stats["readmitted"] += 1
        self.events.append(ReadmissionEvent(
            worker=name, at=now, recalibrated=bool(worker.codec_bws)))
        return worker

    # -- reduce / telemetry --------------------------------------------------

    def completions(self) -> Dict[str, List]:
        """Per-worker completion lists (dead workers keep what they
        finished before dying)."""
        return {w.name: list(w.completions) for w in self.registry
                if hasattr(w, "completions")}

    def completion_for(self, request_id: int):
        """The completion that served ``request_id``, wherever it ran
        (None if still pending or shed)."""
        for comps in self.completions().values():
            for c in comps:
                if c.request_id == request_id:
                    return c
        return None

    def placement_for(self, request_id: int) -> List[PlacementRecord]:
        """Every routing decision made for ``request_id`` (>1 after a
        failover re-route)."""
        return [p for p in self.placements if p.request_id == request_id]

    def stats_snapshot(self) -> Dict:
        """Router counters + per-worker runtime snapshots, one consistent
        copy."""
        snap = dict(self.stats)
        snap["rejections"] = dict(self.stats["rejections"])
        snap["alive"] = [w.name for w in self.registry.alive()]
        snap["dead"] = self.registry.dead()
        snap["failovers"] = sum(isinstance(e, FailoverEvent)
                                for e in self.events)
        snap["readmissions"] = sum(isinstance(e, ReadmissionEvent)
                                   for e in self.events)
        snap["breakers"] = {name: br.snapshot()
                            for name, br in self.breakers.items()}
        snap["workers"] = {w.name: w.stats_snapshot()
                           for w in self.registry}
        return snap
