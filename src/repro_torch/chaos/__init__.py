"""`repro_torch.chaos` — deterministic fault injection for the fleet tier.

The paper's claim is that profiling-driven *adaptation* makes edge
inference practical; this package is how the repo proves the adaptation
survives an unhealthy fleet.  A :class:`FaultSchedule` scripts bandwidth
drift, link flaps, worker death/stall/revive, and per-dispatch
stragglers/transport errors from an explicit seed; a
:class:`ChaosController` replays the schedule against a
:class:`~repro_torch.fleet.registry.DeviceRegistry` /
:class:`~repro_torch.fleet.router.FleetRouter` pair on the virtual clock — the
same schedule produces the same event log in tests and
``python -m repro_torch.launch.fleet --chaos <spec>``.

    schedule = (FaultSchedule.drift("edge-a", 0, 8, 600, 60, seed=7)
                .add(FaultSchedule.kill("edge-b", 2.0),
                     FaultSchedule.revive("edge-b", 5.0)))
    chaos = ChaosController(registry, schedule, router=router)
    out = router.drive_virtual(requests, events=chaos.events())
    chaos.log                      # [[t, kind, target, value], ...]

The *response* side — bounded retry with exponential backoff, per-dispatch
timeouts, a per-worker circuit breaker, and worker re-admission
(revive → re-calibrate → re-profile → re-enter placement) — lives in
``repro_torch.fleet``.
"""
from repro_torch.chaos.controller import ChaosController
from repro_torch.chaos.schedule import ChaosEvent, DispatchFault, FaultSchedule

__all__ = ["ChaosController", "ChaosEvent", "DispatchFault",
           "FaultSchedule"]
