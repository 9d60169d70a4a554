"""Elastic re-meshing: track the healthy ranks and rebuild the mesh and its
sharding plan after losing some.

Port of ``repro.runtime.elastic``.  PRISM's sequence-partition count P is
a runtime parameter, so the system is elastic: on failure the mesh is
rebuilt from the surviving ranks, the sharding plan re-derived (P follows
the model-axis size) and the checkpointed state restored onto it.  The
members are gloo ranks (``devices`` a list of rank ids, by default every
rank of the initialised process group), a mesh is a
``repro_torch.launch.mesh.Mesh`` of them, and restoring with new
placements is the checkpoint manager's ``restore(..., placements=)``:
each rank reads its blocks of the global arrays under the new plan (the
port's ``jax.device_put`` with new shardings).  ``launch.train --resume``
starts the survivors as the new mesh from the newest checkpoint.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np

from repro_torch.launch.mesh import Mesh
from repro_torch.sharding.specs import make_plan


def _default_devices() -> list:
    """The ranks of the initialised process group (rank 0 alone without
    one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return list(range(dist.get_world_size()))
    return [0]


@dataclasses.dataclass
class ElasticMeshManager:
    """Tracks the healthy ranks and rebuilds mesh + plan on change."""
    cfg: Any
    mode: Any
    L: int = 0
    devices: Optional[list] = None

    def __post_init__(self):
        self.devices = list(self.devices if self.devices is not None
                            else _default_devices())

    def build(self, axis_shape: Tuple[int, ...],
              axis_names: Tuple[str, ...]):
        n = int(np.prod(axis_shape))
        devs = np.asarray(self.devices[:n]).reshape(axis_shape)
        mesh = Mesh(devs, axis_names)
        return mesh, make_plan(mesh, self.cfg, self.mode, L=self.L)

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
        n = len(self.devices)
        shape = largest_mesh_shape(n)
        names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                           "model")
        return self.build(shape, names)


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
    """One-shot helper: mesh + plan for the surviving rank count."""
    mgr = ElasticMeshManager(cfg, mode, L=L,
                             devices=list(range(surviving)))
    return mgr.best_mesh()
