"""Timing helpers: an accumulating host-clock ``Timer`` and ``timeit_torch``.

Port of ``repro.utils.timing``.  ``timeit_torch`` is what the ``measured``
profiling backend times the session's executables with: on a CUDA device
each call runs between two CUDA events on the current stream, so the time
is the card's, not the enqueue's; on the CPU it is the host clock.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

import torch


@dataclass
class Timer:
    """Accumulating timer; ``with timer.scope("x"): ...`` records wall time."""

    records: dict = field(default_factory=dict)

    def scope(self, name: str):
        return _Scope(self, name)

    def add(self, name: str, dt: float) -> None:
        self.records.setdefault(name, []).append(dt)

    def mean_ms(self, name: str) -> float:
        xs = self.records.get(name, [])
        return 1e3 * sum(xs) / max(len(xs), 1)


class _Scope:
    def __init__(self, timer: Timer, name: str):
        self.timer, self.name = timer, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.timer.add(self.name, time.perf_counter() - self.t0)
        return False


def _first_tensor(obj: Any) -> Optional[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return obj
    items = (obj.values() if isinstance(obj, dict)
             else obj if isinstance(obj, (list, tuple)) else ())
    for item in items:
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


def timeit_torch(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median time (seconds) of one ``fn(*args)`` (the upper one of an
    even count, as ``repro.utils.timing.timeit_jax`` takes it).

    The device is that of the first tensor in ``args`` (the CPU when there
    is none).  On a CUDA device each call is timed between two CUDA events
    recorded on the current stream (``elapsed_time`` after a synchronise on
    the end event); on the CPU with ``time.perf_counter``.
    """
    lead = _first_tensor(args)
    device = lead.device if lead is not None else torch.device("cpu")
    for _ in range(warmup):
        fn(*args)
    times = []
    if device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            fn(*args)
            end.record(stream)
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]
