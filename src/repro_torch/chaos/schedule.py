"""Deterministic fault schedules — the *script* of a chaos run.

A :class:`FaultSchedule` is a sorted list of :class:`ChaosEvent`s on the
virtual clock: link-bandwidth drift and flaps, worker death/stall/revive,
and per-dispatch stragglers/transport errors.  All randomness happens at
*build* time from an explicit seed (the drift walk uses
:class:`~repro_torch.utils.bandwidth.BandwidthWalk`), so the same schedule —
replayed through a :class:`~repro_torch.chaos.controller.ChaosController` — is
identical in tests, benchmarks, and ``launch/fleet.py --chaos <spec>``:
same seed, same event log.

Schedules compose (``a + b`` merges and re-sorts) and parse from a compact
spec string for the launcher::

    kill:edge-b@1.5; revive:edge-b@4; drift:edge-a@0:600->60:8;
    flap:edge-c@2:0.5; straggle:edge-b@1:4; error:edge-b@1; stall:edge-a@2:0.5
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

from repro_torch.utils.bandwidth import BandwidthWalk

KINDS = ("bandwidth", "flap", "kill", "stall", "revive", "straggle",
         "error")


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scripted fault.

    ``t`` is virtual seconds; ``value`` is kind-specific (Mbps for
    ``bandwidth``, straggle factor for ``straggle``, modeled abort window
    in seconds for ``error``); ``duration`` applies to ``flap``/``stall``.
    """
    t: float
    kind: str
    target: str
    value: float = 0.0
    duration: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown chaos event kind {self.kind!r}; "
                             f"known: {KINDS}")
        if self.t < 0:
            raise ValueError(f"event time must be >= 0, got {self.t}")


@dataclasses.dataclass(frozen=True)
class DispatchFault:
    """One failed dispatch a worker reports to the router (the breaker /
    retry-telemetry feed).  ``retried`` are request ids the worker re-queued
    locally with backoff; ``gave_up`` are requests whose per-dispatch retry
    budget is exhausted — the router must re-place them elsewhere."""
    worker: str
    kind: str                       # "error" | "timeout"
    t: float
    retried: Tuple[int, ...] = ()
    gave_up: Tuple = ()             # Request objects, not ids


class FaultSchedule:
    """An ordered, seed-deterministic list of :class:`ChaosEvent`s."""

    def __init__(self, events: Iterable[ChaosEvent] = ()):
        self.events: List[ChaosEvent] = sorted(
            events, key=lambda e: (e.t, e.kind, e.target, e.value))

    # -- composition ---------------------------------------------------------

    def add(self, *events: ChaosEvent) -> "FaultSchedule":
        self.events = sorted(self.events + list(events),
                             key=lambda e: (e.t, e.kind, e.target, e.value))
        return self

    def __add__(self, other: "FaultSchedule") -> "FaultSchedule":
        return FaultSchedule(self.events + other.events)

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    # -- builders ------------------------------------------------------------

    @staticmethod
    def kill(target: str, t: float) -> ChaosEvent:
        return ChaosEvent(t, "kill", target)

    @staticmethod
    def revive(target: str, t: float) -> ChaosEvent:
        return ChaosEvent(t, "revive", target)

    @staticmethod
    def stall(target: str, t: float, duration: float) -> ChaosEvent:
        return ChaosEvent(t, "stall", target, duration=duration)

    @staticmethod
    def set_bandwidth(target: str, t: float, mbps: float) -> ChaosEvent:
        return ChaosEvent(t, "bandwidth", target, value=mbps)

    @staticmethod
    def flap(target: str, t: float, duration: float,
             floor_mbps: float = 1.0) -> ChaosEvent:
        """Link flap: bandwidth drops to ``floor_mbps`` at ``t`` and is
        restored (to its pre-flap value, captured at apply time) after
        ``duration`` seconds."""
        return ChaosEvent(t, "flap", target, value=floor_mbps,
                          duration=duration)

    @staticmethod
    def straggle(target: str, t: float, factor: float) -> ChaosEvent:
        """Arm ONE straggling dispatch: the target's next dispatch at or
        after ``t`` takes ``factor``× its modeled service time."""
        return ChaosEvent(t, "straggle", target, value=factor)

    @staticmethod
    def transport_error(target: str, t: float,
                        abort_s: float = 0.05) -> ChaosEvent:
        """Arm ONE failing dispatch: the target's next dispatch at or after
        ``t`` aborts with a :class:`~repro_torch.transport.links.TransportError`
        after ``abort_s`` modeled seconds (its requests re-queue and
        retry with backoff)."""
        return ChaosEvent(t, "error", target, value=abort_s)

    @classmethod
    def drift(cls, target: str, t0: float, t1: float, from_mbps: float,
              to_mbps: float, *, steps: int = 16, seed: int = 0,
              jitter: float = 0.1) -> "FaultSchedule":
        """Seeded bandwidth drift: a :class:`BandwidthWalk` from
        ``from_mbps`` to ``to_mbps`` over [t0, t1], sampled at ``steps``
        evenly-spaced set-bandwidth events.  Same seed → same walk → same
        events."""
        if t1 <= t0:
            raise ValueError(f"drift needs t1 > t0, got [{t0}, {t1}]")
        walk = BandwidthWalk(from_mbps, to_mbps, seed=seed, jitter=jitter)
        dt = (t1 - t0) / max(steps, 1)
        evs = [cls.set_bandwidth(target, t0 + (i + 1) * dt,
                                 walk.at((i + 1) / max(steps, 1)))
               for i in range(steps)]
        return cls(evs)

    # -- the launcher spec string --------------------------------------------

    @classmethod
    def parse(cls, spec: str) -> "FaultSchedule":
        """Parse the compact ``--chaos`` spec (see module docstring).

        Each clause is ``kind:target@t[:args]``; clauses separated by
        ``;``.  ``drift`` takes ``from->to:duration``."""
        sched = cls()
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            try:
                kind, rest = clause.split(":", 1)
                target_t, *args = rest.split(":")
                target, t_s = target_t.split("@")
                t = float(t_s)
            except ValueError:
                raise ValueError(
                    f"bad chaos clause {clause!r} (want "
                    "kind:target@t[:args])") from None
            kind = kind.strip()
            if kind == "kill":
                sched.add(cls.kill(target, t))
            elif kind == "revive":
                sched.add(cls.revive(target, t))
            elif kind == "bw":
                sched.add(cls.set_bandwidth(target, t, float(args[0])))
            elif kind == "flap":
                sched.add(cls.flap(target, t, float(args[0]),
                                   *(float(a) for a in args[1:2])))
            elif kind == "stall":
                sched.add(cls.stall(target, t, float(args[0])))
            elif kind == "straggle":
                sched.add(cls.straggle(target, t, float(args[0])))
            elif kind == "error":
                sched.add(cls.transport_error(
                    target, t, *(float(a) for a in args[:1])))
            elif kind == "drift":
                span, dur = args[0], float(args[1]) if len(args) > 1 else 4.0
                lo, hi = span.split("->")
                sched += cls.drift(target, t, t + dur, float(lo), float(hi))
            else:
                raise ValueError(f"unknown chaos kind {kind!r} in "
                                 f"{clause!r}")
        return sched
