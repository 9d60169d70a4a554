"""Elastic re-meshing: track the healthy device set and find the largest
viable mesh after losing devices.

Port of ``repro.runtime.elastic``.  The membership bookkeeping
(``ElasticMeshManager.drop`` by explicit ids or by count,
``largest_mesh_shape``) is the JAX package's, exactly.  Building the mesh
and its sharding plan (``build``, ``best_mesh``, ``replan_for_failure``)
needs a JAX ``Mesh`` and ``repro.sharding.specs.make_plan``, which have no
counterpart in the port yet (ROADMAP queue 1 item [13], ``sharding/specs``):
those raise ``NotImplementedError``.  A port deployment re-partitions by
starting a seq group of the surviving size (``repro_torch.core.seq_group``)
and restoring the replicated checkpoint into it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np

_NO_MESH = ("the port has no device mesh or sharding plan yet (ROADMAP "
            "queue 1 item [13], sharding/specs); start a seq group of the "
            "surviving size and restore the checkpoint into it")


def _default_devices() -> list:
    import torch
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass
class ElasticMeshManager:
    """Tracks the healthy device set (and would rebuild mesh + plan on
    change)."""
    cfg: Any
    mode: Any
    L: int = 0
    devices: Optional[list] = None

    def __post_init__(self):
        self.devices = list(self.devices if self.devices is not None
                            else _default_devices())

    def build(self, axis_shape: Tuple[int, ...],
              axis_names: Tuple[str, ...]):
        raise NotImplementedError(f"ElasticMeshManager.build: {_NO_MESH}")

    def drop(self, failed, rebuild: bool = True):
        """Remove failed devices and return the largest viable mesh.

        ``failed`` is either an iterable of failed devices (device objects
        — matched by identity/equality — or their ``.id``s) or an int
        count, which truncates the tail of the device list.
        ``rebuild=False`` skips mesh construction (callers that only track
        membership)."""
        if isinstance(failed, (int, np.integer)):
            if failed < 0 or failed > len(self.devices):
                raise ValueError(f"cannot drop {failed} of "
                                 f"{len(self.devices)} devices")
            self.devices = self.devices[:len(self.devices) - failed]
        else:
            failed = list(failed)
            dead_idx = set()
            for f in failed:
                hit = [i for i, d in enumerate(self.devices)
                       if d is f or d == f or getattr(d, "id", None) == f]
                if not hit:
                    raise ValueError(f"failed device {f!r} is not in the "
                                     "healthy device set")
                dead_idx.update(hit)
            self.devices = [d for i, d in enumerate(self.devices)
                            if i not in dead_idx]
        if not rebuild:
            return None
        return self.best_mesh()

    def best_mesh(self):
        raise NotImplementedError(f"ElasticMeshManager.best_mesh: {_NO_MESH}")


def largest_mesh_shape(n_devices: int) -> Tuple[int, ...]:
    """Largest (data, model) grid with model a power of two ≤ 16 that fits
    in ``n_devices`` — PRISM's P re-balances to the new model-axis size."""
    best = (1, 1)
    for model in (16, 8, 4, 2, 1):
        data = n_devices // model
        if data >= 1 and data * model > best[0] * best[1]:
            best = (data, model)
    return best


def replan_for_failure(cfg, mode, surviving: int, L: int = 0):
    """Mesh + plan for the surviving device count (not in the port yet)."""
    raise NotImplementedError(f"replan_for_failure: {_NO_MESH}")
