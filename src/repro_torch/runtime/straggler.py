"""Straggler mitigation for the synchronous exchange.

A copy of ``repro.runtime.straggler``.

The paper's profiling decomposition makes stragglers visible: per-device
step times are profiled; devices persistently slower than the fleet median
by ``threshold`` get their sequence partition shrunk (PRISM's partitions
need not be equal — the master re-balances the position-wise split), which
is the edge-appropriate analogue of backup workers. The rebalancer outputs
integer token counts per device summing to N, biased inversely to measured
speed, quantized to the segment size so L stays integral.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class StragglerMitigator:
    n_devices: int
    ema_alpha: float = 0.25
    threshold: float = 1.3         # flag if step_time > 1.3 × median
    history_len: int = 50

    def __post_init__(self):
        self._ema = np.ones(self.n_devices)
        self._seen = 0

    def observe(self, step_times: np.ndarray) -> None:
        """step_times: [n_devices] wall seconds for the last step."""
        t = np.asarray(step_times, float)
        if self._seen == 0:
            self._ema = t
        else:
            self._ema = self.ema_alpha * t + (1 - self.ema_alpha) * self._ema
        self._seen += 1

    def stragglers(self) -> List[int]:
        med = float(np.median(self._ema))
        return [i for i, t in enumerate(self._ema)
                if t > self.threshold * med]

    def rebalanced_partitions(self, n_tokens: int, seg_size: int
                              ) -> List[int]:
        """Token counts per device ∝ measured speed, quantized to segments.

        Every device keeps at least one segment and the counts always sum to
        ``(n_tokens // seg_size) · seg_size`` (= ``n_tokens`` when it is
        segment-aligned): rounding drift is repaired by largest-remainder
        allocation instead of dumping a possibly-negative correction on the
        fastest device (which under extreme skew used to drive its partition
        to zero or below).
        """
        total = n_tokens // seg_size
        if total < self.n_devices:
            raise ValueError(
                f"{n_tokens} tokens / seg_size {seg_size} yield {total} "
                f"segments — fewer than {self.n_devices} devices (every "
                "device needs at least one segment)")
        speed = 1.0 / np.maximum(self._ema, 1e-9)
        share = speed / speed.sum() * total
        segs = np.maximum(np.floor(share).astype(int), 1)
        frac = share - np.floor(share)
        # grant leftover segments by largest fractional remainder
        # (fastest-first on ties); reclaim overdraft from the devices with
        # the most segments (slowest-first on ties), never below one
        while segs.sum() < total:
            i = int(np.lexsort((-speed, -frac))[0])
            segs[i] += 1
            frac[i] = -1.0
        while segs.sum() > total:
            donors = np.where(segs > 1)[0]
            i = donors[int(np.lexsort((speed[donors], -segs[donors]))[0])]
            segs[i] -= 1
        return list(segs * seg_size)
