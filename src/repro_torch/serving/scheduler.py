"""Adaptive micro-batch scheduler + runtime hooks.

A copy of ``repro.serving.scheduler`` with its imports pointed into the
port.

The paper's policy decides *how* a batch executes (local vs distributed(CR))
— the scheduler decides *what the batch is*: it queries the compiled
:class:`~repro_torch.profiling.table.PolicyTable` across the profiled batch
grid (:meth:`PolicyTable.plan_batch`) and forms the micro-batch whose size
AND mode/CR minimize the active objective per queued request, padding to
the nearest profiled grid point (flagged) when the queue is short.  On
integrated-GPU edge hardware batch composition is the dominant performance
lever (arXiv 2508.08430), so batch formation goes through the same profiled
table as routing.

Two hook classes wire the ``repro_torch.runtime`` machinery into the
serving loop:

* :class:`StragglerHook` — feeds observed per-device step times to
  :class:`~repro_torch.runtime.straggler.StragglerMitigator` and, when a
  device persistently lags, derives rebalanced sequence partitions for the
  active PRISM plan.
* :class:`FaultHook` — heartbeat-miss detection
  (:class:`~repro_torch.runtime.fault.HeartbeatMonitor`) → elastic
  re-mesh (:meth:`~repro_torch.runtime.elastic.ElasticMeshManager.drop`,
  or any ``mesh_manager`` with ``devices`` and ``drop(ids,
  rebuild=False)``, given the *explicit* failed ids) → the runtime
  re-admits in-flight requests.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

from repro_torch.core.policy import BatchPlan, ObjectiveLike, resolve_objective
from repro_torch.serving.queue import Request, RequestQueue


@dataclasses.dataclass
class MicroBatch:
    """One scheduling decision: these requests, this plan, this shape."""
    requests: List[Request]
    plan: BatchPlan                        # table-derived batch formation
    exec_key: str                          # executable id ("local"/"prism@x")

    @property
    def extrapolated(self) -> bool:
        return self.plan.extrapolated or self.plan.decision.extrapolated


class AdaptiveScheduler:
    """Forms micro-batches from the queue via the compiled policy table.

    ``session`` supplies the profiled policy and the bandwidth estimate;
    ``objective`` defaults to the session's.  ``max_wait_ms`` bounds how
    long the scheduler holds a short queue hoping to fill the cheapest
    profiled batch before admitting what it has (latency/throughput knob).
    """

    def __init__(self, session, objective: Optional[ObjectiveLike] = None,
                 max_wait_ms: float = 0.0):
        self.session = session
        self.objective = (resolve_objective(objective) if objective
                          else session.objective)
        self.max_wait_ms = max_wait_ms
        self.history: List[MicroBatch] = []

    def _table(self):
        return self.session.policy.table(self.objective)

    def plan_batch(self, n_queued: int,
                   max_batch: Optional[int] = None) -> BatchPlan:
        return self._table().plan_batch(n_queued, self.session.bandwidth,
                                        max_batch=max_batch)

    def next_batch(self, queue: RequestQueue, free_slots: int,
                   idle: bool = True,
                   now: Optional[float] = None) -> Optional[MicroBatch]:
        """Form the next micro-batch, or None to wait.

        Holds back only when the pool is still busy (``idle=False``), the
        queue is shorter than the planned batch wants, and nothing has
        waited past ``max_wait_ms`` — a brief hold can fill a cheaper grid
        batch, but never at the cost of an idle pool or a deadline.
        """
        if not queue or free_slots <= 0:
            return None
        plan = self.plan_batch(len(queue), max_batch=free_slots)
        if (not idle and plan.n_admit < plan.batch
                and queue.oldest_wait_ms(now) < self.max_wait_ms):
            return None
        reqs = queue.pop_many(plan.n_admit, now=now)
        if not reqs:                   # everything queued had expired
            return None
        mb = MicroBatch(requests=reqs, plan=plan,
                        exec_key=plan.decision.exec_key)
        self.history.append(mb)
        return mb


# ---------------------------------------------------------------------------
# runtime hooks
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RebalanceEvent:
    """A straggler-driven partition rebalance proposal."""
    stragglers: List[int]                  # device indices flagged
    partitions: List[int]                  # proposed token counts per device
    n_tokens: int
    seg_size: int


class StragglerHook:
    """Feed observed per-device step times into the mitigator; when a
    device persistently lags, emit rebalanced sequence partitions for the
    active plan (PRISM's partitions need not be equal — the master
    re-balances the position-wise split)."""

    def __init__(self, n_devices: int, seg_size: int = 1, **mitigator_kw):
        from repro_torch.runtime.straggler import StragglerMitigator
        self.mitigator = StragglerMitigator(n_devices=n_devices,
                                            **mitigator_kw)
        self.seg_size = max(int(seg_size), 1)
        self.events: List[RebalanceEvent] = []
        self.chunk_walls_ms: List[float] = []

    def observe_chunk(self, wall_ms: float, n_steps: int) -> None:
        """Record one decode chunk's per-step wall time (runtime
        telemetry).  This deliberately does NOT feed the mitigator: a
        single-host chunk wall has no per-device resolution, and uniform
        fabricated times would both never flag a straggler and dilute any
        genuine per-device observations fed through :meth:`observe`."""
        self.chunk_walls_ms.append(wall_ms / max(n_steps, 1))

    def observe(self, step_times: Sequence[float],
                n_tokens: int) -> Optional[RebalanceEvent]:
        """Called once per decode chunk with per-device wall times; returns
        a rebalance proposal iff a straggler is (still) flagged.  A
        workload too small to give every device a segment yields no
        proposal — telemetry must never abort the serving loop."""
        self.mitigator.observe(step_times)
        stragglers = self.mitigator.stragglers()
        if not stragglers:
            return None
        if n_tokens // self.seg_size < self.mitigator.n_devices:
            return None
        parts = self.mitigator.rebalanced_partitions(n_tokens, self.seg_size)
        ev = RebalanceEvent(stragglers=stragglers, partitions=parts,
                            n_tokens=n_tokens, seg_size=self.seg_size)
        self.events.append(ev)
        return ev


@dataclasses.dataclass
class FailoverEvent:
    """One heartbeat-miss → re-mesh → re-admit cycle."""
    dead: List[Any]
    survivors: int
    requeued: int


class FaultHook:
    """Heartbeat-driven failover: detect dead participants, shrink the
    device set through :class:`ElasticMeshManager` (explicit ids — the
    tail-truncation bug is fixed), and tell the runtime to re-admit
    whatever was in flight."""

    def __init__(self, monitor=None, mesh_manager=None,
                 nodes: Sequence[str] = ("n0",), timeout_s: float = 10.0):
        from repro_torch.runtime.fault import HeartbeatMonitor
        self.monitor = monitor or HeartbeatMonitor(list(nodes),
                                                   timeout_s=timeout_s)
        self.mesh_manager = mesh_manager
        self.events: List[FailoverEvent] = []

    def beat(self, node: str) -> None:
        self.monitor.beat(node)

    def check(self) -> Optional[List[str]]:
        """Dead node list iff a failover should run now (once per failure:
        dead nodes are dropped from future checks)."""
        dead = self.monitor.dead_nodes()
        if not dead:
            return None
        for n in dead:                     # consume: controller drops them
            self.monitor.remove(n)
        if self.mesh_manager is not None:
            known = [d for d in dead if self._known(d)]
            if known:
                self.mesh_manager.drop(known, rebuild=False)
        return dead

    def _known(self, node) -> bool:
        devs = self.mesh_manager.devices
        return any(d is node or d == node or getattr(d, "id", None) == node
                   for d in devs)

    def record(self, dead: List[Any], requeued: int) -> FailoverEvent:
        ev = FailoverEvent(dead=list(dead),
                           survivors=(len(self.mesh_manager.devices)
                                      if self.mesh_manager else
                                      len(self.monitor.nodes)),
                           requeued=requeued)
        self.events.append(ev)
        return ev
