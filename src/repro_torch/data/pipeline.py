"""Synthetic input data (numpy only, seeded, host-side, prefetching).

Copy of ``repro.data.pipeline``: the LM stream is a Zipf-ish Markov chain
(so next-token loss has signal) and the image task embeds the class label
in low-frequency image structure.  Every draw is the JAX package's, from
the same ``numpy.random.RandomState`` calls in the same order, so the same
seed gives the same arrays bit for bit in both packages.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    order: int = 2          # Markov order — gives the LM something to learn

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        V = self.vocab_size
        # sparse transition table: each context maps to 8 likely tokens
        self._succ = rng.randint(0, V, size=(V, 8))

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.RandomState(self.seed + 1)
        while True:
            yield self.sample(rng)

    def sample(self, rng) -> Dict[str, np.ndarray]:
        B, N, V = self.batch_size, self.seq_len, self.vocab_size
        toks = np.empty((B, N + 1), np.int32)
        toks[:, 0] = rng.randint(0, V, size=B)
        for t in range(1, N + 1):
            ctx = toks[:, t - 1]
            choice = rng.randint(0, 8, size=B)
            noise = rng.rand(B) < 0.1
            nxt = self._succ[ctx, choice]
            nxt = np.where(noise, rng.randint(0, V, size=B), nxt)
            toks[:, t] = nxt
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_lm_batch(vocab: int, batch: int, seq: int, seed: int = 0
                  ) -> Dict[str, np.ndarray]:
    ds = SyntheticLMDataset(vocab, seq, batch, seed=seed)
    return ds.sample(np.random.RandomState(seed))


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


def synthetic_vit_task(batch: int, seed: int = 0):
    return SyntheticImageDataset(batch_size=batch, seed=seed).sample()


class Prefetcher:
    """Background-thread prefetch wrapper around any batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
