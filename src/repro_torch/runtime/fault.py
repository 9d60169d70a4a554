"""Fault tolerance: heartbeats and failure detection.

The part of ``repro.runtime.fault`` the serving runtime's ``FaultHook``
uses: ``HeartbeatMonitor`` (deadline-based liveness) and ``FaultEvent``.
The monitor is transport-agnostic: callers feed ``beat()``/``fail()``.
``RetryPolicy`` and ``CircuitBreaker`` come with the fleet tier (ROADMAP
queue 1 item 10); ``FaultTolerantLoop`` needs the checkpoint manager and
waits for ROADMAP queue 1 item 12.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional


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
