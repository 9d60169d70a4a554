"""Request queue for the serving runtime.

A copy of ``repro.serving.queue``.

A :class:`Request` is one generation job (prompt → ``n_new`` tokens) with an
arrival timestamp and an optional per-request SLO deadline; the bounded
:class:`RequestQueue` holds admitted-but-unscheduled requests and hands the
scheduler deadline-ordered candidates.  PRISM-style systems treat
distributed edge inference as a *request-serving* problem (arXiv
2507.12145) — this module is the front door of that framing.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

_ids = itertools.count()


class QueueFull(RuntimeError):
    """The bounded request queue rejected an arrival (backpressure).

    ``reason`` tells telemetry *why* the put was shed: ``"full"`` (the
    bound) or ``"dead_worker"`` (the fleet router refused a worker that
    missed its heartbeat)."""

    def __init__(self, msg: str, reason: str = "full"):
        super().__init__(msg)
        self.reason = reason


@dataclasses.dataclass
class Request:
    """One generation job.

    ``prompt`` is a 1-D token id array (length T0); ``slo_ms`` is the
    per-request latency objective measured from ``arrival_ts`` (None = best
    effort).  ``seed``/``temperature`` pin the sampling chain so a served
    request is token-exact with ``session.generate(prompt[None], n_new,
    seed=seed)``.
    """
    prompt: np.ndarray
    n_new: int
    slo_ms: Optional[float] = None
    seed: int = 0
    temperature: float = 0.0
    arrival_ts: float = dataclasses.field(default_factory=time.monotonic)
    id: int = dataclasses.field(default_factory=lambda: next(_ids))
    # trace context: set by whichever tier first sees the request (router
    # or runtime) and carried across the RPC wire so the subprocess
    # worker's spans land in the same tree
    trace_id: str = ""
    parent_span: str = ""

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt)
        if self.prompt.ndim == 2 and self.prompt.shape[0] == 1:
            self.prompt = self.prompt[0]
        if self.prompt.ndim != 1 or self.prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array, "
                             f"got shape {self.prompt.shape}")
        if self.n_new <= 0:
            raise ValueError(f"n_new must be >= 1, got {self.n_new}")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.n_new

    def deadline(self) -> float:
        """Absolute deadline (monotonic clock); +inf when best-effort."""
        if self.slo_ms is None:
            return float("inf")
        return self.arrival_ts + self.slo_ms / 1e3


class RequestQueue:
    """Bounded FIFO with earliest-deadline-first scheduling order.

    ``put`` raises :class:`QueueFull` beyond ``max_size`` — serving systems
    need explicit backpressure, not an unbounded buffer.  ``pop`` hands out
    the earliest-deadline request (arrival order among equals), which is
    what the scheduler admits into free slots.

    ``shed_expired=True`` makes ``pop``/``pop_many`` drop requests whose
    SLO deadline has already passed (counted under the ``"expired"``
    rejection reason, kept in ``self.expired``) instead of dispatching
    work that can no longer meet its deadline — opt-in, because a
    best-effort deployment may prefer late answers over none.
    """

    def __init__(self, max_size: int = 1024, shed_expired: bool = False):
        if max_size <= 0:
            raise ValueError("max_size must be >= 1")
        self.max_size = max_size
        self.shed_expired = shed_expired
        self._q: Deque[Request] = deque()
        self.expired: List[Request] = []
        # shed accounting: every refused put, by reason — the router's shed
        # rate must be visible in telemetry, not a silent exception
        self.rejections: Dict[str, int] = {}

    @property
    def rejected(self) -> int:
        """Total puts this queue refused (all reasons)."""
        return sum(self.rejections.values())

    def reject(self, reason: str) -> None:
        """Record an externally-decided rejection (e.g. the fleet router
        refusing a dead worker before ever calling ``put``)."""
        self.rejections[reason] = self.rejections.get(reason, 0) + 1

    def put(self, req: Request, force: bool = False) -> Request:
        """``force=True`` bypasses the bound — reserved for the runtime
        re-queuing work it already admitted (failover, overflow); dropping
        an in-flight request to enforce backpressure would lose it."""
        if not force and len(self._q) >= self.max_size:
            self.reject("full")
            raise QueueFull(f"queue at capacity ({self.max_size})")
        self._q.append(req)
        return req

    def drain(self) -> List[Request]:
        """Remove and return every queued request (dead-worker path: the
        fleet router re-routes them; EDF order is recovered by the target
        queue's ``pop``, which orders by deadline, not insertion)."""
        out = list(self._q)
        self._q.clear()
        return out

    def shed_expired_now(self, now: Optional[float] = None) -> List[Request]:
        """Drop every queued request whose deadline has passed (counted
        under the ``"expired"`` reason); returns what was shed."""
        now = time.monotonic() if now is None else now
        shed = [r for r in self._q if r.deadline() < now]
        if shed:
            self._q = deque(r for r in self._q if r.deadline() >= now)
            self.expired.extend(shed)
            for _ in shed:
                self.reject("expired")
        return shed

    def pop(self, now: Optional[float] = None) -> Request:
        """Earliest deadline first; FIFO among equal deadlines.  With
        ``shed_expired``, deadline-passed requests are dropped first."""
        if self.shed_expired:
            self.shed_expired_now(now)
        if not self._q:
            raise IndexError("pop from empty RequestQueue")
        best_i = min(range(len(self._q)),
                     key=lambda i: (self._q[i].deadline(),
                                    self._q[i].arrival_ts))
        self._q.rotate(-best_i)
        req = self._q.popleft()
        self._q.rotate(best_i)
        return req

    def pop_many(self, n: int, now: Optional[float] = None) -> List[Request]:
        out: List[Request] = []
        while self._q and len(out) < n:
            try:
                out.append(self.pop(now))
            except IndexError:      # every remaining request expired
                break
        return out

    def oldest_wait_ms(self, now: Optional[float] = None) -> float:
        """Milliseconds the longest-waiting request has queued (0 if empty)."""
        if not self._q:
            return 0.0
        now = time.monotonic() if now is None else now
        return 1e3 * (now - min(r.arrival_ts for r in self._q))

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def __iter__(self):
        return iter(self._q)
