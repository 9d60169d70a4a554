"""Training loop wiring: data cursor + fault-tolerant loop + checkpoints.

Port of ``repro.train.loop``.  The inner step is ``build_train_step``;
this module adds the deterministic data cursor (seed ⊕ step → batch),
checkpoint cadence and the heartbeat, so the ``FaultTolerantLoop`` can
restart it bit-exactly.  The trainer beats its monitor after every step
(the JAX package's trainer never beats, so a run longer than the
monitor's 10 s deadline there counts its own host as dead).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.core.exchange import ExchangeConfig
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.models import registry
from repro_torch.runtime.fault import FaultTolerantLoop, HeartbeatMonitor
from repro_torch.train.optimizer import OptConfig, adamw_init
from repro_torch.train.train_step import build_train_step

HOST = "host0"


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 200
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    seed: int = 0
    log_every: int = 10
    batch_size: int = 8
    seq_len: int = 128


class Trainer:
    """Trainer of one process (the same step code that runs SPMD on every
    rank of a seq group), on ``device``: the card unless the caller asks
    for the CPU; asking for the card without one raises.  ``params``
    (optional) replaces the seeded draw, e.g. weights carried over from the
    JAX package."""

    def __init__(self, cfg: ModelConfig, xcfg: ExchangeConfig,
                 tcfg: Optional[TrainerConfig] = None,
                 opt_cfg: Optional[OptConfig] = None, device="cuda",
                 params=None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer(device='cuda') needs a CUDA card; "
                               "pass device='cpu' to train on the CPU")
        tcfg = tcfg or TrainerConfig()
        self.cfg, self.xcfg, self.tcfg, self.device = cfg, xcfg, tcfg, device
        self.params = (registry.init_params(cfg, seed=tcfg.seed,
                                            device=device)
                       if params is None else params)
        self.opt_state = adamw_init(self.params)
        self.step_fn = build_train_step(cfg, xcfg, opt_cfg)
        self.ds = SyntheticLMDataset(cfg.vocab_size, tcfg.seq_len,
                                     tcfg.batch_size, seed=tcfg.seed)
        self.metrics_log: list = []

    def batch_for_step(self, step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.RandomState(self.tcfg.seed * 100003 + step)
        b = self.ds.sample(rng)
        return {k: torch.from_numpy(v).to(self.device) for k, v in b.items()}

    def run(self, n_steps: Optional[int] = None, fail_at=None):
        n = n_steps or self.tcfg.steps
        ckpt = CheckpointManager(self.tcfg.ckpt_dir, keep=2)
        monitor = HeartbeatMonitor([HOST])

        def step_fn(state, batch):
            params, opt = state
            params, opt, m = self.step_fn(params, opt, batch)
            self.metrics_log.append({k: float(v) for k, v in m.items()})
            monitor.beat(HOST)
            return (params, opt), m

        loop = FaultTolerantLoop(step_fn, self.batch_for_step, ckpt, monitor,
                                 ckpt_every=self.tcfg.ckpt_every)
        self.loop = loop
        (self.params, self.opt_state), step = loop.run(
            (self.params, self.opt_state), 0, n, fail_at=fail_at)
        return step
