"""`repro_torch.fleet` — policy-placed multi-worker serving over a device registry.

The unit of scale becomes the *worker*: a :class:`DeviceRegistry` of named
workers (real :class:`WorkerHandle` = session + serving runtime, or
virtual-time :class:`SimWorker` for fleet-scale benchmarking), each pinned
to its own hardware/link profile with its own compiled policy table, and a
:class:`FleetRouter` front door that scores placements with those tables,
admits into per-worker bounded EDF queues with explicit backpressure
(:class:`FleetRejected`), and re-routes a dead worker's in-flight requests
token-exactly on heartbeat miss.

    registry = DeviceRegistry()
    registry.add(SimWorker("fast", hardware=JETSON_ORIN_NANO))
    registry.add(SimWorker("slow",
                           hardware=scaled_hardware(JETSON_ORIN_NANO, 0.5)))
    router = FleetRouter(registry)
    req, rec = router.submit(prompt, n_new=16)
    print(rec.explain())                  # the full scored ranking

Robustness (PR 7): dispatch failures stream through ``Worker.pop_faults``
into a per-worker :class:`~repro_torch.runtime.fault.CircuitBreaker`; a
:class:`~repro_torch.runtime.fault.RetryPolicy` bounds local re-dispatch and
placement retries; ``FleetRouter.readmit`` runs the full revive →
re-calibrate → re-profile → re-place cycle.  Faults are injected — never
ad-hoc — through :mod:`repro_torch.chaos`.
"""
from repro_torch.fleet.registry import (DeviceRegistry, SimCompletion, SimWorker,
                                  Worker, WorkerHandle, scaled_hardware)
from repro_torch.fleet.router import (FleetRejected, FleetRouter, PlacementRecord,
                                ReadmissionEvent, WorkerScore)

__all__ = [
    "DeviceRegistry", "Worker", "WorkerHandle", "SimWorker",
    "SimCompletion", "scaled_hardware",
    "FleetRouter", "FleetRejected", "PlacementRecord", "ReadmissionEvent",
    "WorkerScore",
]
