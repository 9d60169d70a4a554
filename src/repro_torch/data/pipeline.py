"""Synthetic input data (numpy only, seeded).

Copy of ``repro.data.pipeline.SyntheticImageDataset``: the same seed gives
the same images in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticImageDataset:
    """224² images whose class is encoded in low-frequency structure."""
    n_classes: int = 10
    batch_size: int = 16
    seed: int = 0
    noise: float = 0.35

    def sample(self, rng: Optional[np.random.RandomState] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        rng = rng or np.random.RandomState(self.seed)
        B, C = self.batch_size, self.n_classes
        labels = rng.randint(0, C, size=B)
        xs = np.linspace(0, 2 * np.pi, 224)
        yy, xx = np.meshgrid(xs, xs, indexing="ij")
        imgs = np.empty((B, 224, 224, 3), np.float32)
        for i, c in enumerate(labels):
            f = 1 + c % 5
            phase = (c // 5) * np.pi / 2
            base = np.sin(f * xx + phase) * np.cos(f * yy)
            img = np.stack([base, np.roll(base, 37, 0), -base], -1)
            imgs[i] = img + self.noise * rng.randn(224, 224, 3)
        return imgs.astype(np.float32), labels.astype(np.int32)

    def batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.RandomState(self.seed)
        while True:
            yield self.sample(rng)
