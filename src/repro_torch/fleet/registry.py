"""Device registry: named workers with pinned hardware + liveness.

The ROADMAP's "millions of users" axis makes the *worker* the unit of
scale: one :class:`DeviceRegistry` tracks a fleet of named workers, each
pinned to its own :class:`~repro_torch.profiling.hardware.HardwareProfile` /
:class:`~repro_torch.profiling.hardware.LinkProfile` and carrying its own
compiled :class:`~repro_torch.profiling.table.PolicyTable` — per-device
capability differences dominate once more than one request shares a board
(PRISM, arXiv 2507.12145; the Jetson concurrent-workload profiling study),
so placement must query per-worker tables, not a fleet-wide average.

Two worker flavors share one interface (:class:`Worker`):

* :class:`WorkerHandle` — a *real* worker: an
  :class:`~repro_torch.api.session.InferenceSession` + its
  :class:`~repro_torch.serving.engine.ServingRuntime` (bounded EDF queue →
  adaptive scheduler → slot-pool decode).  Used by the token-exactness
  tests and ``launch/fleet.py --real``.
* :class:`SimWorker` — a *virtual-time* worker: the same bounded EDF queue
  and the same compiled policy table, but service is modeled (one profiled
  inference pass per generated token) so a single host can benchmark a
  heterogeneous fleet without serializing real decode.

Liveness reuses the existing :class:`~repro_torch.runtime.fault.HeartbeatMonitor`
(deadline-based; ``fail()`` wins over ``beat()``); ``check_dead()`` follows
the :class:`~repro_torch.serving.scheduler.FaultHook` consume pattern — a worker
is reported dead exactly once, and the router drains + re-routes it then.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, List, Optional

from repro_torch.chaos.schedule import DispatchFault
from repro_torch.obs import MetricsRegistry, StatsDict, request_trace_id
from repro_torch.profiling.hardware import (JETSON_ORIN_NANO, WIFI_GLOO,
                                      HardwareProfile, LinkProfile)
from repro_torch.runtime.fault import HeartbeatMonitor, RetryPolicy
from repro_torch.serving.queue import Request, RequestQueue


def scaled_hardware(base: HardwareProfile, factor: float,
                    name: Optional[str] = None) -> HardwareProfile:
    """A heterogeneous-fleet variant of ``base``: effective-FLOP/s curve
    scaled by ``factor`` (a 0.5 board computes at half speed; overheads and
    power are board-level constants and stay put)."""
    if factor <= 0:
        raise ValueError(f"factor must be > 0, got {factor}")
    return dataclasses.replace(
        base, name=name or f"{base.name}-x{factor:g}",
        eff_inf=base.eff_inf * factor, eff_slope=base.eff_slope * factor)


class Worker:
    """One fleet member: a name, a hardware/link pin, a bounded EDF queue,
    and a compiled policy table the router scores placements with.

    Subclasses implement the service loop (``step``/``next_event_at``) and
    the drain path; everything the :class:`~repro_torch.fleet.router.FleetRouter`
    touches is on this base interface.
    """

    name: str
    hardware: HardwareProfile
    link: LinkProfile
    queue: RequestQueue
    n_slots: int
    codec_bws: Dict[str, float] = {}       # per-device codec calibration
    # provenance: True when codec_bws was measured on the worker's own
    # process (RpcWorker Calibrate); False for eff_inf-scaled host estimates
    codec_bws_measured: bool = False
    # wire-health flag: in-process workers are always healthy; an RpcWorker
    # flips this when its socket/process is gone so the router stops
    # beating it and the heartbeat-death drain path takes over
    healthy: bool = True

    # -- placement inputs ----------------------------------------------------

    @property
    def bandwidth(self) -> float:
        """Estimated link bandwidth (Mbps) fed to the policy table."""
        raise NotImplementedError

    def table(self, objective=None):
        """This worker's compiled PolicyTable (its hardware, its sweep)."""
        raise NotImplementedError

    @property
    def in_flight(self) -> int:
        raise NotImplementedError

    @property
    def pending(self) -> int:
        """Requests this worker still owes: queued + in flight."""
        return len(self.queue) + self.in_flight

    @property
    def idle(self) -> bool:
        return self.in_flight == 0

    # -- intake / service ----------------------------------------------------

    def submit_request(self, req: Request, force: bool = False) -> Request:
        raise NotImplementedError

    def step(self, now: Optional[float] = None) -> List:
        """Advance service; returns the completions this step produced."""
        raise NotImplementedError

    def next_event_at(self, now: float) -> float:
        """Virtual-time drivers: when this worker next has work to do
        (``inf`` = nothing queued or in flight)."""
        raise NotImplementedError

    # -- failure / telemetry -------------------------------------------------

    def drain_requests(self) -> List[Request]:
        """Give up every queued and in-flight request (dead-worker path)."""
        raise NotImplementedError

    def pop_faults(self) -> List[DispatchFault]:
        """Dispatch failures since the last call (consume pattern — the
        router feeds these to the per-worker circuit breaker)."""
        return []

    def reprofile(self, codec_bws: Optional[Dict[str, float]] = None) -> None:
        """Re-run this worker's profiling sweep (re-admission path); when
        ``codec_bws`` is given the sweep sees those per-device measured
        codec decode throughputs."""
        raise NotImplementedError

    def stats_snapshot(self) -> Dict:
        raise NotImplementedError

    @property
    def served_tokens(self) -> int:
        raise NotImplementedError

    def __repr__(self):
        return (f"{type(self).__name__}({self.name!r}, "
                f"hw={self.hardware.name!r}, pending={self.pending})")


class WorkerHandle(Worker):
    """A real worker: an ``InferenceSession`` + ``ServingRuntime`` pinned to
    one hardware/link profile.

    The session must already be profiled (``session.profile(...)``) —
    typically with ``hardware=``/``link=`` matching the pin, so the
    worker's policy table predicts *this* device.  The runtime's bounded
    EDF queue doubles as the router's per-worker admission queue.
    """

    def __init__(self, name: str, session, *,
                 hardware: HardwareProfile = JETSON_ORIN_NANO,
                 link: LinkProfile = WIFI_GLOO,
                 runtime=None, n_slots: int = 4, chunk: int = 8,
                 max_len: int = 256, queue_size: int = 64, sweep=None,
                 metrics: Optional[MetricsRegistry] = None, tracer=None):
        from repro_torch.serving.engine import ServingRuntime
        self.name = name
        self.session = session
        self.hardware = hardware
        self.link = link
        self.sweep = sweep
        self.codec_bws: Dict[str, float] = {}
        self.profiled_count = 1 if session.perfmap is not None else 0
        self.runtime = runtime or ServingRuntime(
            session, n_slots=n_slots, chunk=chunk, max_len=max_len,
            queue_size=queue_size, metrics=metrics, tracer=tracer,
            worker=name)
        self.queue = self.runtime.queue
        self.n_slots = self.runtime.n_slots
        self.runtime.chaos_name = name
        if runtime is not None:
            self.runtime.trace_worker = self.runtime.trace_worker or name

    @property
    def tracer(self):
        return self.runtime.tracer

    @tracer.setter
    def tracer(self, tr) -> None:
        self.runtime.tracer = tr

    @property
    def metrics(self):
        return self.runtime.metrics

    @property
    def bandwidth(self) -> float:
        return self.session.bandwidth

    def observe_bandwidth(self, mbps: float) -> None:
        self.session.observe_bandwidth(mbps)

    def reprofile(self, codec_bws: Optional[Dict[str, float]] = None) -> None:
        """Re-sweep this worker's session at its own hardware/link pin,
        with its per-device codec calibration installed for the sweep.
        Simulated backend: re-admission must not monopolize the device."""
        from repro_torch.transport.codecs import codec_overrides
        bws = codec_bws if codec_bws is not None else self.codec_bws
        if codec_bws is not None:
            self.codec_bws = dict(codec_bws)
        with codec_overrides(bws or {}):
            self.session.profile(self.sweep, backend="simulated",
                                 hardware=self.hardware, link=self.link)
        self.profiled_count += 1

    def table(self, objective=None):
        return self.session.policy.table(objective or self.session.objective)

    @property
    def in_flight(self) -> int:
        return sum(p.n_active for p in self.runtime.pools.values())

    def submit_request(self, req: Request, force: bool = False) -> Request:
        if req.total_len > self.runtime.max_len:
            raise ValueError(
                f"request needs {req.total_len} positions but worker "
                f"{self.name!r} pools are sized for {self.runtime.max_len}")
        return self.queue.put(req, force=force)

    def step(self, now: Optional[float] = None) -> List:
        return self.runtime.step()

    def next_event_at(self, now: float) -> float:
        return now if (self.queue or not self.runtime.idle) else float("inf")

    def drain_requests(self) -> List[Request]:
        return self.runtime.drain_requests()

    def stats_snapshot(self) -> Dict:
        return self.runtime.stats_snapshot()

    @property
    def completions(self) -> List:
        return self.runtime.completions

    @property
    def served_tokens(self) -> int:
        return sum(len(c.tokens) for c in self.runtime.completions)


@dataclasses.dataclass
class SimCompletion:
    """One virtually-served request (no token payload — service is modeled,
    the *timing* is the artifact)."""
    request_id: int
    n_tokens: int
    worker: str
    arrival_ts: float
    admitted_ts: float
    finished_ts: float
    plan_key: str = "local"
    slo_ms: Optional[float] = None

    @property
    def latency_ms(self) -> float:
        return 1e3 * (self.finished_ts - self.arrival_ts)

    @property
    def queue_ms(self) -> float:
        return 1e3 * (self.admitted_ts - self.arrival_ts)


class SimWorker(Worker):
    """A virtual-time worker: real compiled policy table, modeled service.

    Placement and batch formation go through exactly the same
    ``PolicyTable.plan_batch`` query a real worker uses — over a perf map
    profiled at *this worker's* hardware/link — but serving one micro-batch
    is modeled as ``expected.total_ms`` per generated token (one profiled
    inference pass per decode step) instead of running decode.  That keeps
    a single benchmark host able to drive 3+ heterogeneous workers in
    virtual time, where real decode would serialize them.
    """

    def __init__(self, name: str, perfmap=None, *,
                 hardware: HardwareProfile = JETSON_ORIN_NANO,
                 link: LinkProfile = WIFI_GLOO,
                 bandwidth_mbps: float = 400.0, n_slots: int = 4,
                 queue_size: int = 64, objective="latency",
                 allow_modes=("local", "prism"), sweep=None,
                 adaptive: bool = True, shed_expired: bool = False,
                 dispatch_timeout_s: Optional[float] = None,
                 retry: Optional[RetryPolicy] = None,
                 metrics: Optional[MetricsRegistry] = None, tracer=None):
        from repro_torch.core.policy import AdaptivePolicy, resolve_objective
        self.name = name
        self.hardware = hardware
        self.link = link
        self.n_slots = n_slots
        self.queue = RequestQueue(queue_size, shed_expired=shed_expired)
        self._bandwidth = float(bandwidth_mbps)
        # static baseline: plan at the bandwidth seen at construction and
        # never look again (what a non-adaptive deployment would run)
        self._plan_bandwidth = float(bandwidth_mbps)
        self.adaptive = adaptive
        self.objective = resolve_objective(objective)
        self._allow_modes = tuple(allow_modes)
        self.sweep = sweep
        self.codec_bws: Dict[str, float] = {}
        self.profiled_count = 0
        if perfmap is None:
            perfmap = self._sweep_perfmap()
            self.profiled_count = 1
        self.perfmap = perfmap
        self.policy = AdaptivePolicy(perfmap, allow_modes=self._allow_modes)
        # fault-injection / response state
        self.chaos = None                     # set by ChaosController.attach
        self.retry = retry or RetryPolicy()
        self.dispatch_timeout_s = dispatch_timeout_s
        self._stall_until = 0.0
        self._fail_kind: Optional[str] = None  # in-service dispatch doomed?
        self._faults: List[DispatchFault] = []
        self._attempts: Dict[int, int] = {}    # request id → failed tries
        self._consec_failures = 0
        # virtual service state
        self._in_service: List[Request] = []
        self._service_start = 0.0
        self._busy_until = 0.0
        self._service_key = "local"
        self.completions: List[SimCompletion] = []
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer              # spans get virtual timestamps
        self.stats = StatsDict(
            self.metrics, "fleet.worker",
            {"steps": 0, "admitted": 0, "served": 0, "tokens": 0,
             "max_concurrent": 0, "busy_s": 0.0, "retries": 0,
             "timeouts": 0, "transport_errors": 0, "straggled": 0,
             "gave_up": 0},
            labels={"worker": name})

    def _sweep_perfmap(self):
        from repro_torch.profiling import ProfileContext, SweepSpec, get_backend
        from repro_torch.transport.codecs import codec_overrides
        with codec_overrides(self.codec_bws or {}):
            return get_backend("simulated").profile(
                ProfileContext(hardware=self.hardware, link=self.link),
                self.sweep or SweepSpec())

    def reprofile(self, codec_bws: Optional[Dict[str, float]] = None) -> None:
        """Rebuild the perf map / policy table (re-admission path), sweeping
        under this device's measured codec decode throughputs if given."""
        from repro_torch.core.policy import AdaptivePolicy
        if codec_bws is not None:
            self.codec_bws = dict(codec_bws)
        self.perfmap = self._sweep_perfmap()
        self.policy = AdaptivePolicy(self.perfmap,
                                     allow_modes=self._allow_modes)
        self.profiled_count += 1

    @property
    def bandwidth(self) -> float:
        return self._bandwidth

    def observe_bandwidth(self, mbps: float) -> None:
        self._bandwidth = float(mbps)

    def table(self, objective=None):
        return self.policy.table(objective or self.objective)

    @property
    def in_flight(self) -> int:
        return len(self._in_service)

    def submit_request(self, req: Request, force: bool = False) -> Request:
        return self.queue.put(req, force=force)

    # -- virtual service loop ------------------------------------------------

    def step(self, now: Optional[float] = None) -> List[SimCompletion]:
        """Advance to virtual time ``now``: finish the in-service batch if
        its modeled service time has elapsed, then (if idle and not in a
        stall/backoff window) admit the next table-formed micro-batch."""
        if now is None:
            raise ValueError("SimWorker.step needs the virtual time `now`")
        self.stats["steps"] += 1
        done: List[SimCompletion] = []
        if self._in_service and now >= self._busy_until - 1e-12:
            fin = self._busy_until
            if self._fail_kind is not None:
                self._finish_failed(fin)
            else:
                for req in self._in_service:
                    done.append(SimCompletion(
                        request_id=req.id, n_tokens=req.n_new,
                        worker=self.name, arrival_ts=req.arrival_ts,
                        admitted_ts=self._service_start, finished_ts=fin,
                        plan_key=self._service_key, slo_ms=req.slo_ms))
                    self.stats["served"] += 1
                    self.stats["tokens"] += req.n_new
                    self._attempts.pop(req.id, None)
                    if self.tracer is not None:
                        self._trace_served(req, fin)
                self.completions.extend(done)
                self._in_service = []
                self._consec_failures = 0
        if (not self._in_service and self.queue
                and now >= self._stall_until - 1e-12):
            self._admit(now)
        return done

    def _admit(self, now: float) -> None:
        table = self.table()
        plan_bw = self._bandwidth if self.adaptive else self._plan_bandwidth
        bp = table.plan_batch(len(self.queue), plan_bw,
                              max_batch=self.n_slots)
        reqs = self.queue.pop_many(bp.n_admit, now=now)
        if not reqs:                       # everything queued had expired
            return
        self._in_service = reqs
        self._service_start = now
        self._service_key = bp.decision.exec_key
        # one profiled pass per generated token; wall time is charged even
        # under the energy objective (the clock is not an objective), so
        # total_ms — not objective.cost — is the model.  A static planner
        # still pays the TRUE link: its chosen plan is re-costed at the
        # live bandwidth.
        service_s = 1e-3 * self._charged_ms(table, bp) * max(
            r.n_new for r in reqs)
        self._fail_kind = None
        fault = (self.chaos.dispatch_fault(self.name, now)
                 if self.chaos is not None else None)
        if fault is not None and fault.kind == "straggle":
            service_s *= max(fault.value, 1.0)
            self.stats["straggled"] += 1
        elif fault is not None and fault.kind == "error":
            # transport error surfaces after `value` seconds of wire time
            self._fail_kind = "error"
            service_s = min(service_s, max(fault.value, 1e-6))
        if (self._fail_kind is None and self.dispatch_timeout_s is not None
                and service_s > self.dispatch_timeout_s):
            self._fail_kind = "timeout"
            service_s = self.dispatch_timeout_s
        self._busy_until = now + service_s
        self.stats["admitted"] += len(reqs)
        self.stats["busy_s"] += service_s
        self.stats["max_concurrent"] = max(self.stats["max_concurrent"],
                                           len(reqs))

    def _trace_served(self, req: Request, fin: float) -> None:
        """Record one served request's tree with *virtual* timestamps:
        root ``request`` (arrival → fin), ``queue_wait`` (arrival or last
        requeue → service start) and ``decode`` (modeled service).  Spans
        are recorded only at completion, so a killed worker contributes
        nothing and the re-serving worker owns the request's tree."""
        if not req.trace_id:
            req.trace_id = request_trace_id(req.id)
        root = self.tracer.record(
            "request", start=req.arrival_ts, end=fin, kind="fleet",
            trace_id=req.trace_id, parent_id=req.parent_span or None,
            worker=self.name, n_new=req.n_new)
        qw0 = getattr(req, "requeued_at", req.arrival_ts)
        self.tracer.record("queue_wait", start=qw0,
                           end=self._service_start, kind="fleet",
                           trace_id=req.trace_id, parent_id=root.span_id,
                           worker=self.name)
        self.tracer.record("decode", start=self._service_start, end=fin,
                           kind="fleet", trace_id=req.trace_id,
                           parent_id=root.span_id, worker=self.name,
                           plan=self._service_key, tokens=req.n_new,
                           modeled=True)

    def _charged_ms(self, table, bp) -> float:
        """Modeled per-token service: the planned decision's cost at the
        TRUE bandwidth (identical to ``expected.total_ms`` for an adaptive
        worker, which planned at the true bandwidth already)."""
        d = bp.decision
        if self.adaptive:
            return d.expected.total_ms
        for key, exp in table.candidates(bp.batch, self._bandwidth):
            if (key.mode, key.cr, key.codec) == (d.mode, d.cr, d.codec):
                return exp.total_ms
        return d.expected.total_ms

    def _finish_failed(self, fin: float) -> None:
        """The in-service dispatch failed (transport error / timeout):
        requeue within the retry budget, give up past it, and back off
        exponentially before the next local dispatch."""
        kind = self._fail_kind or "error"
        self.stats["timeouts" if kind == "timeout"
                   else "transport_errors"] += 1
        retried, gave_up = [], []
        for req in self._in_service:
            n = self._attempts.get(req.id, 0) + 1
            self._attempts[req.id] = n
            if n > self.retry.max_retries:
                gave_up.append(req)
                self._attempts.pop(req.id, None)
                self.stats["gave_up"] += 1
            else:
                self.queue.put(req, force=True)
                req.requeued_at = fin
                retried.append(req.id)
                self.stats["retries"] += 1
            if self.tracer is not None:
                if not req.trace_id:
                    req.trace_id = request_trace_id(req.id)
                self.tracer.record(
                    "retry", start=fin, end=fin, kind="fleet",
                    trace_id=req.trace_id,
                    parent_id=req.parent_span or None, worker=self.name,
                    reason=kind, attempt=n,
                    gave_up=n > self.retry.max_retries)
        self._in_service = []
        self._fail_kind = None
        self._consec_failures += 1
        self._stall_until = max(
            self._stall_until,
            fin + self.retry.backoff_s(self._consec_failures - 1))
        self._faults.append(DispatchFault(
            worker=self.name, kind=kind, t=fin,
            retried=tuple(retried), gave_up=tuple(gave_up)))

    def apply_stall(self, t: float, duration: float) -> None:
        """Scripted stall: no admissions until ``t + duration``; an
        in-service batch finishes late by the stall length."""
        self._stall_until = max(self._stall_until, t + duration)
        if self._in_service:
            self._busy_until += duration
            self.stats["busy_s"] += duration

    def next_event_at(self, now: float) -> float:
        if self._in_service:
            return self._busy_until
        if self.queue:
            return max(now, self._stall_until)
        return float("inf")

    # -- failure / telemetry -------------------------------------------------

    def drain_requests(self) -> List[Request]:
        reqs = self.queue.drain()
        reqs.extend(self._in_service)
        self._in_service = []
        self._busy_until = 0.0
        self._fail_kind = None
        return reqs

    def pop_faults(self) -> List[DispatchFault]:
        out, self._faults = self._faults, []
        return out

    def stats_snapshot(self) -> Dict:
        snap = dict(self.stats)
        snap["queue_depth"] = len(self.queue)
        snap["in_flight"] = len(self._in_service)
        snap["completed"] = len(self.completions)
        snap["rejected"] = self.queue.rejected
        snap["rejections"] = dict(self.queue.rejections)
        snap["expired"] = self.queue.rejections.get("expired", 0)
        snap["profiled_count"] = self.profiled_count
        return snap

    @property
    def served_tokens(self) -> int:
        return self.stats["tokens"]


class DeviceRegistry:
    """Named workers + heartbeat liveness (the fleet's source of truth).

    ``add()`` registers a worker and starts its heartbeat deadline;
    ``beat()``/``fail()`` feed the monitor (``fail`` wins — an explicitly
    failed worker's beats are ignored, which is what lets the router
    auto-beat workers it successfully steps).  ``check_dead()`` is the
    consume edge: each dead worker is reported exactly once, at which point
    the router drains and re-routes it.

    ``calibrate_codecs=True`` runs the measured decode-throughput
    micro-benchmark (:func:`~repro_torch.transport.codecs.calibrate_codec_bws`)
    at registry construction — once, on this host's ``device`` (the card
    unless the caller asks for the CPU) — and every worker
    added afterwards gets a *per-device* copy scaled to its own
    :class:`HardwareProfile` (``eff_inf`` ratio vs ``host_hardware``): a
    board that computes at 0.35× the host reconstructs codec payloads at
    0.35× the host's measured throughput.  The worker is then re-profiled
    under its own calibration, so its policy table prices codecs the way
    *that device* would pay for them.  ``readmit()`` repeats the scale +
    re-profile on revival.
    """

    def __init__(self, *, heartbeat_timeout_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic,
                 calibrate_codecs: bool = False,
                 host_hardware: HardwareProfile = JETSON_ORIN_NANO,
                 metrics: Optional[MetricsRegistry] = None,
                 device="cuda"):
        self.monitor = HeartbeatMonitor([], timeout_s=heartbeat_timeout_s,
                                        clock=clock)
        self.workers: Dict[str, Worker] = {}
        self._dead: set = set()
        self.host_hardware = host_hardware
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.codec_bws: Dict[str, float] = {}
        if calibrate_codecs:
            from repro_torch.transport.codecs import calibrate_codec_bws
            self.codec_bws = calibrate_codec_bws(device=device)
            for cname, bw in self.codec_bws.items():
                self.metrics.observe_bandwidth(
                    "codec.decode_bw_bytes_per_s", bw, "measured",
                    codec=cname, worker="host")

    # -- membership ----------------------------------------------------------

    def add(self, worker: Worker) -> Worker:
        if worker.name in self.workers:
            raise ValueError(f"worker {worker.name!r} already registered")
        self.workers[worker.name] = worker
        self.monitor.beat(worker.name)       # starts the liveness deadline
        if self.codec_bws or hasattr(worker, "measure_codec_bws"):
            self.calibrate_worker(worker)
        return worker

    def device_codec_bws(self, worker: Worker) -> Dict[str, float]:
        """Host-measured codec decode throughputs scaled to this worker's
        compute (``eff_inf`` ratio) — the per-device calibration *estimate*,
        used only for workers that cannot measure on their own process."""
        scale = worker.hardware.eff_inf / max(self.host_hardware.eff_inf,
                                              1e-9)
        return {name: bw * scale for name, bw in self.codec_bws.items()}

    def _codec_bws_for(self, worker: Worker):
        """(bws, measured) for this worker: measured on the worker's own
        process when it can (``measure_codec_bws`` — the RPC boundary), the
        eff_inf-scaled host estimate otherwise."""
        measure = getattr(worker, "measure_codec_bws", None)
        if measure is not None:
            try:
                bws = measure()
            except Exception:          # wire hiccup: fall back to estimate
                bws = None
            if bws:
                return dict(bws), True
        return self.device_codec_bws(worker), False

    def _gauge_codec_bws(self, worker: Worker, bws: Dict[str, float],
                         measured: bool) -> None:
        """Per-device codec throughputs land in one provenance-labelled
        gauge — ``measured`` when the worker benchmarked its own process
        (RPC boundary), ``estimated`` for eff_inf-scaled host numbers."""
        prov = "measured" if measured else "estimated"
        for cname, bw in bws.items():
            self.metrics.observe_bandwidth(
                "codec.decode_bw_bytes_per_s", bw, prov,
                codec=cname, worker=worker.name)

    def calibrate_worker(self, worker: Worker) -> Dict[str, float]:
        """Install the per-device codec calibration and re-profile the
        worker under it (no-op dict if neither the worker nor the host can
        supply numbers).  Records ``codec_bws_measured`` provenance."""
        bws, measured = self._codec_bws_for(worker)
        worker.codec_bws_measured = measured
        if bws:
            self._gauge_codec_bws(worker, bws, measured)
            worker.reprofile(codec_bws=bws)
        return bws

    def get(self, name: str) -> Worker:
        try:
            return self.workers[name]
        except KeyError:
            raise KeyError(f"unknown worker {name!r}; registered: "
                           f"{sorted(self.workers)}") from None

    def remove(self, name: str) -> None:
        self.workers.pop(name, None)
        self._dead.discard(name)
        self.monitor.remove(name)

    @property
    def names(self) -> List[str]:
        return sorted(self.workers)

    def __len__(self) -> int:
        return len(self.workers)

    def __iter__(self) -> Iterator[Worker]:
        return iter(self.workers.values())

    # -- liveness ------------------------------------------------------------

    def beat(self, name: str) -> None:
        self.monitor.beat(name)

    def fail(self, name: str) -> None:
        """Mark a worker dead (kill switch; heartbeat misses also kill)."""
        if name not in self.workers:
            raise KeyError(f"unknown worker {name!r}")
        self.monitor.fail(name)

    def revive(self, name: str) -> None:
        self._dead.discard(name)
        self.monitor.revive(name)

    def readmit(self, name: str, *, recalibrate: bool = True,
                reprofile: bool = True) -> Worker:
        """Full re-admission: revive → re-calibrate codecs for this device
        → re-profile → the worker is placeable again.  A revived board may
        come back throttled or on a different link, so its policy table
        must be rebuilt before placement trusts it (the router's
        :meth:`~repro_torch.fleet.router.FleetRouter.readmit` also resets the
        worker's circuit breaker)."""
        worker = self.get(name)
        # a process-backed worker whose process died must come back up
        # before it can recalibrate/reprofile (RpcWorker.respawn)
        respawn = getattr(worker, "respawn", None)
        if respawn is not None and not getattr(worker, "healthy", True):
            respawn()
        self.revive(name)
        if recalibrate and (self.codec_bws
                            or hasattr(worker, "measure_codec_bws")):
            worker.codec_bws, worker.codec_bws_measured = \
                self._codec_bws_for(worker)
            if worker.codec_bws:
                self._gauge_codec_bws(worker, worker.codec_bws,
                                      worker.codec_bws_measured)
        if reprofile:
            worker.reprofile(codec_bws=worker.codec_bws or None)
        return worker

    def is_alive(self, name: str) -> bool:
        return (name in self.workers and name not in self._dead
                and name not in self.monitor.dead_nodes())

    def alive(self) -> List[Worker]:
        dead = set(self.monitor.dead_nodes()) | self._dead
        return [w for n, w in sorted(self.workers.items()) if n not in dead]

    def dead(self) -> List[str]:
        return sorted((set(self.monitor.dead_nodes()) | self._dead)
                      & set(self.workers))

    def check_dead(self) -> List[str]:
        """Newly-dead workers (consume pattern: each reported once — the
        caller owns draining + re-routing them)."""
        newly = [n for n in self.monitor.dead_nodes()
                 if n in self.workers and n not in self._dead]
        for n in newly:
            self.monitor.remove(n)
            self._dead.add(n)
        return newly
