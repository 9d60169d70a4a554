"""ChaosController — replays one :class:`FaultSchedule` against a fleet.

One controller is the single choke point through which every scripted
fault reaches the system, so the same schedule produces the same run in
tests, benchmarks, and ``launch/fleet.py --chaos``:

* **membership faults** (``kill`` / ``revive``) go through the
  :class:`~repro_torch.fleet.registry.DeviceRegistry` (and the router's
  re-admission path, so a revived worker re-profiles and re-enters
  placement);
* **link faults** (``bandwidth`` / ``flap``) set the live bandwidth the
  worker's policy table queries — degradation flips plans toward
  local/compressed execution through the existing
  :class:`~repro_torch.profiling.table.PolicyTable`, no special-case code;
* **dispatch faults** (``straggle`` / ``error``) are *armed* at their
  schedule time and consumed by the target worker's next dispatch
  (:meth:`dispatch_fault`), which is what exercises the retry/timeout/
  breaker machinery.

Every applied or consumed fault lands in ``controller.log`` — a plain
list of ``[t, kind, target, value]`` rows — and two runs of the same
seeded schedule must produce identical logs.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.chaos.schedule import ChaosEvent, FaultSchedule


class ChaosController:
    """Bind a :class:`FaultSchedule` to a registry (+ optional router)."""

    def __init__(self, registry, schedule: FaultSchedule, *, router=None):
        self.registry = registry
        self.router = router
        self.schedule = schedule
        self.log: List[List] = []
        # armed per-dispatch faults, FIFO per worker
        self._armed: Dict[str, List[ChaosEvent]] = {}
        self._preflap: Dict[Tuple[str, float], float] = {}
        self.attach()

    # -- wiring ---------------------------------------------------------------

    def attach(self) -> None:
        """Point every chaos-capable worker at this controller (SimWorkers
        consume dispatch faults directly; WorkerHandles through their
        runtime's chaos hook)."""
        for w in self.registry:
            if hasattr(w, "chaos"):
                w.chaos = self
            elif hasattr(w, "runtime") and hasattr(w.runtime, "chaos"):
                w.runtime.chaos = self

    def events(self) -> List[Tuple[float, Callable]]:
        """``(t, fn)`` callbacks for ``FleetRouter.drive_virtual`` —
        flaps expand into a down event and a restore event."""
        out: List[Tuple[float, Callable]] = []
        for ev in self.schedule:
            if ev.kind == "flap":
                out.append((ev.t, lambda e=ev: self._flap_down(e)))
                out.append((ev.t + ev.duration,
                            lambda e=ev: self._flap_up(e)))
            else:
                out.append((ev.t, lambda e=ev: self.apply(e)))
        return sorted(out, key=lambda p: p[0])

    # -- applying scripted faults ---------------------------------------------

    def _log(self, t: float, kind: str, target: str, value: float) -> None:
        self.log.append([round(float(t), 9), kind, target,
                         round(float(value), 6)])

    def apply(self, ev: ChaosEvent) -> None:
        if ev.kind == "kill":
            # process-backed workers die for real: SIGKILL the subprocess
            # first so the wire goes down exactly like an actual crash,
            # then mark the membership change
            w = self.registry.workers.get(ev.target)
            killer = getattr(w, "kill_process", None)
            if killer is not None:
                killer()
                # the router stops stepping a dead member, so the client
                # would never discover the corpse on its own — record what
                # this controller just did, and readmission knows to respawn
                w.healthy = False
            if self.registry.is_alive(ev.target):
                self.registry.fail(ev.target)
            self._log(ev.t, "kill", ev.target, 0.0)
        elif ev.kind == "revive":
            if self.router is not None:
                self.router.readmit(ev.target, now=ev.t)
            else:
                self.registry.readmit(ev.target)
            self._log(ev.t, "revive", ev.target, 0.0)
        elif ev.kind == "bandwidth":
            self._set_bandwidth(ev.target, ev.value)
            self._log(ev.t, "bandwidth", ev.target, ev.value)
        elif ev.kind == "stall":
            w = self.registry.get(ev.target)
            w.apply_stall(ev.t, ev.duration)
            self._log(ev.t, "stall", ev.target, ev.duration)
        elif ev.kind in ("straggle", "error"):
            self._armed.setdefault(ev.target, []).append(ev)
            self._log(ev.t, f"arm_{ev.kind}", ev.target, ev.value)
        else:
            raise ValueError(f"controller cannot apply {ev.kind!r}")

    def _set_bandwidth(self, target: str, mbps: float) -> None:
        w = self.registry.get(target)
        if hasattr(w, "observe_bandwidth"):
            w.observe_bandwidth(mbps)
        elif hasattr(w, "session"):
            w.session.observe_bandwidth(mbps)
        else:
            raise TypeError(f"worker {target!r} exposes no bandwidth knob")

    def _flap_down(self, ev: ChaosEvent) -> None:
        w = self.registry.get(ev.target)
        self._preflap[(ev.target, ev.t)] = float(w.bandwidth)
        self._set_bandwidth(ev.target, ev.value)
        self._log(ev.t, "flap_down", ev.target, ev.value)

    def _flap_up(self, ev: ChaosEvent) -> None:
        restore = self._preflap.pop((ev.target, ev.t), None)
        if restore is None:                 # flap on an unknown pre-state
            return
        self._set_bandwidth(ev.target, restore)
        self._log(ev.t + ev.duration, "flap_up", ev.target, restore)

    # -- per-dispatch faults (consumed by workers) ----------------------------

    def dispatch_fault(self, worker: str,
                       now: float) -> Optional[ChaosEvent]:
        """The next armed dispatch fault for ``worker`` whose schedule time
        has passed, or None.  Each armed fault fires exactly once — a
        retried dispatch does not re-hit the same injection."""
        armed = self._armed.get(worker)
        if not armed or armed[0].t > now:
            return None
        ev = armed.pop(0)
        self._log(now, f"hit_{ev.kind}", worker, ev.value)
        return ev

    @property
    def pending_faults(self) -> int:
        return sum(len(v) for v in self._armed.values())
