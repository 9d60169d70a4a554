"""Fault tolerance: heartbeats and failure detection.

``HeartbeatMonitor`` (deadline-based liveness, used by the serving
runtime's ``FaultHook`` and the fleet registry) and ``FaultEvent``; the
monitor is transport-agnostic: callers feed ``beat()``/``fail()``.
``RetryPolicy`` (bounded exponential backoff) and ``CircuitBreaker``
(per-worker dispatch-failure breaker) are shared by the fleet router and
its workers.  ``FaultTolerantLoop`` needs the checkpoint manager and
waits for ROADMAP queue 1 item 12.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass
class FaultEvent:
    kind: str                 # "node_down" | "straggler" | "restart"
    detail: str
    step: int
    wall: float = dataclasses.field(default_factory=time.time)


class HeartbeatMonitor:
    """Deadline-based liveness tracking for participant nodes."""

    def __init__(self, nodes: List[str], timeout_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout_s
        self._clock = clock
        self._last: Dict[str, float] = {n: clock() for n in nodes}
        self._failed: set[str] = set()

    def beat(self, node: str, at: Optional[float] = None) -> None:
        if node not in self._failed:
            self._last[node] = self._clock() if at is None else at

    def fail(self, node: str) -> None:
        self._failed.add(node)

    def revive(self, node: str) -> None:
        """The controller replaced/recovered the node: clear its failure
        and restart its deadline."""
        self._failed.discard(node)
        self.beat(node)

    def remove(self, node: str) -> None:
        """Drop the node from tracking entirely (it left the fleet)."""
        self._failed.discard(node)
        self._last.pop(node, None)

    def dead_nodes(self) -> List[str]:
        now = self._clock()
        out = [n for n, t in self._last.items()
               if n in self._failed or now - t > self.timeout]
        return sorted(set(out))

    def healthy(self) -> bool:
        return not self.dead_nodes()

    @property
    def nodes(self) -> List[str]:
        return sorted(self._last)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff — shared by the fleet
    router (placement retries, give-up re-placement) and the workers
    (local re-dispatch after a transport error / timeout).

    Attempt ``k`` (0-based) waits ``backoff_base_s · backoff_mult**k``
    before retrying, capped at ``backoff_cap_s`` (a worker that fails for
    a long stretch must not back off past recovery — uncapped doubling
    turns a burst of failures into an astronomically long sleep); after
    ``max_retries`` failed attempts the work is handed back to the caller
    (the router re-places it, or sheds it)."""
    max_retries: int = 3
    backoff_base_s: float = 0.05
    backoff_mult: float = 2.0
    backoff_cap_s: float = 30.0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_base_s < 0 or self.backoff_mult < 1.0:
            raise ValueError("backoff needs base >= 0 and mult >= 1")
        if self.backoff_cap_s <= 0:
            raise ValueError("backoff_cap_s must be > 0")

    def backoff_s(self, attempt: int) -> float:
        """Delay before retry number ``attempt`` (0-based)."""
        return min(self.backoff_base_s * self.backoff_mult
                   ** max(attempt, 0), self.backoff_cap_s)


class CircuitBreaker:
    """Per-worker dispatch-failure breaker (clock-injected, so it works
    identically on the virtual clock).

    ``closed`` → ``open`` after ``fail_threshold`` failures without an
    intervening success; ``open`` → ``half_open`` once
    ``reset_timeout_s`` has elapsed (the next placement is the probe);
    a ``half_open`` success closes, a ``half_open`` failure re-opens.
    Successes while ``open`` are ignored — draining old queue work is
    not evidence the *link* recovered.
    """

    def __init__(self, fail_threshold: int = 3,
                 reset_timeout_s: float = 1.0):
        if fail_threshold <= 0:
            raise ValueError("fail_threshold must be >= 1")
        self.fail_threshold = fail_threshold
        self.reset_timeout_s = reset_timeout_s
        self.state = "closed"              # "closed"|"open"|"half_open"
        self.failures = 0                  # since the last success
        self.opened_at = 0.0
        self.opened_total = 0

    def record_failure(self, now: float) -> bool:
        """Returns True iff this failure newly opened the breaker."""
        self.failures += 1
        if (self.state == "half_open"
                or (self.state == "closed"
                    and self.failures >= self.fail_threshold)):
            self.state = "open"
            self.opened_at = now
            self.opened_total += 1
            return True
        return False

    def record_success(self, now: float) -> None:
        if self.state == "half_open":
            self.state = "closed"
        if self.state == "closed":
            self.failures = 0

    def allows(self, now: float) -> bool:
        """May this worker receive new placements at ``now``?  Flips
        ``open`` → ``half_open`` when the reset window has elapsed."""
        if (self.state == "open"
                and now - self.opened_at >= self.reset_timeout_s):
            self.state = "half_open"
        return self.state != "open"

    def reset(self) -> None:
        """Administrative reset (worker re-admission)."""
        self.state, self.failures = "closed", 0

    def snapshot(self) -> Dict[str, Any]:
        return {"state": self.state, "failures": self.failures,
                "opened_total": self.opened_total}
