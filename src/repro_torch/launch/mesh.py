"""Meshes of gloo ranks: the port's counterpart of ``repro.launch.mesh`` and
of the mesh helpers of ``repro.utils.compat`` (``make_auto_mesh``,
``set_mesh``, ``get_abstract_mesh``).

A ``Mesh`` is a plain description, as JAX's: its axis names and a grid of
global ranks (``devices``), one rank a cell.  It holds no processes, so a
production mesh (16 × 16, or 2 × 16 × 16) can be built and planned
anywhere (``repro_torch.sharding.specs.make_plan``).

``set_mesh(mesh)``, called inside every rank of a process group of
``mesh.size`` ranks, joins it: for each axis it creates one gloo sub-group
per line of the grid along that axis (``dist.new_group``, which every rank
of the world must call, in the same order) and registers this rank's line
as the seq group of that axis name, so ``get_seq_group("model")`` is the
rank's row of a ``("data", "model")`` mesh and ``get_seq_group("data")``
its column; a ``("pod", "data", "model")`` mesh's rank also joins the
group of its batch axes together, ``"pod+data"``.
``seq_group.spawn_mesh`` starts the ranks and joins them;
``join_abstract`` joins one rank of a mesh without them, for the dry run.

``compat.shard_map`` and ``compat.SHARDING_HINTS_SAFE`` have no
counterpart: an SPMD rank already is the body of a ``shard_map``, and
there is no GSPMD layout hint to keep safe.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class Mesh:
    """Axis names and a grid of global ranks (``devices``)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-d grid of ranks for "
                             f"axes {self.axis_names}")

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def empty(self) -> bool:
        return self.size == 0

    def coords(self, rank: int) -> Dict[str, int]:
        """The position of global ``rank`` in the grid, by axis name."""
        where = np.argwhere(self.devices == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not in the mesh")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def lines(self, axes) -> List[List[int]]:
        """Every line of the grid along ``axes`` (an axis name, or a tuple
        of them): the ranks that differ only in those coordinates, in the
        row-major order of those coordinates (the first varies slowest);
        the lines in the row-major order of the other coordinates."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        ks = [self.axis_names.index(a) for a in axes]
        grid = np.moveaxis(self.devices, ks, list(range(-len(ks), 0)))
        n = int(np.prod([self.devices.shape[k] for k in ks]))
        return [[int(r) for r in line] for line in grid.reshape(-1, n)]

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)})"


def make_auto_mesh(shape: Sequence[int], names: Tuple[str, ...]) -> Mesh:
    """A mesh of ``prod(shape)`` ranks, numbered row-major over the axes
    (the last axis varies fastest: a ``("data", "model")`` row is
    consecutive ranks)."""
    shape = tuple(int(s) for s in shape)
    return Mesh(np.arange(int(np.prod(shape))).reshape(shape), names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 single-pod (256 ranks) or 2×16×16 two-pod (512 ranks).

    Axes: ``pod`` (the slow link), ``data`` (batch / FSDP), ``model`` (TP in
    LOCAL mode; the paper's P=16 position-wise sequence partitions in
    PRISM/VOLTAGE modes)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_auto_mesh(shape, axes)


def make_debug_mesh(n_data: int = 4, n_model: int = 2) -> Mesh:
    """A small ``("data", "model")`` mesh for tests."""
    return make_auto_mesh((n_data, n_model), ("data", "model"))


def group_name(axes) -> str:
    """The seq group name of an axis, or of a tuple of axes taken together
    (``"pod+data"``)."""
    return axes if isinstance(axes, str) else "+".join(axes)


def group_axes(mesh: Mesh) -> List[Tuple[str, ...]]:
    """The axes a rank joins a group of: each axis, then the batch axes
    (every axis but ``model``) together where there are several: a
    ``("pod", "data", "model")`` mesh's ZeRO and batch entry
    ``("pod", "data")`` (``sharding.specs``)."""
    out = [(a,) for a in mesh.axis_names]
    batch = tuple(a for a in mesh.axis_names if a != "model")
    if len(batch) > 1:
        out.append(batch)
    return out


_CURRENT: Optional[Mesh] = None
_COORDS: Optional[Dict[str, int]] = None     # join_abstract's coordinates


def set_mesh(mesh: Mesh) -> Mesh:
    """Join ``mesh`` from inside one of its ranks (the process group of
    ``mesh.size`` ranks already initialised): one gloo group per line of
    every axis (``group_axes``: the batch axes together too), this rank's
    line registered as the seq group of the axis name (``group_name``).
    Every rank of the world makes every ``new_group`` call, in the same
    order, or the others hang."""
    global _CURRENT
    import torch.distributed as dist
    from repro_torch.core.seq_group import SeqGroup, register_seq_group
    if _CURRENT is not None:
        raise RuntimeError("this process already joined a mesh")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"a world of {dist.get_world_size()} ranks for a "
                         f"mesh of {mesh.size}")
    rank = dist.get_rank()
    for axes in group_axes(mesh):
        for line in mesh.lines(axes):
            pg = dist.new_group(line, backend="gloo")
            if rank in line:
                register_seq_group(SeqGroup(group_name(axes),
                                            line.index(rank), len(line),
                                            pg=pg, ranks=line))
    _CURRENT = mesh
    return mesh


def join_abstract(mesh: Mesh, coords: Optional[Dict[str, int]] = None
                  ) -> Mesh:
    """Join ``mesh`` as the rank at ``coords`` (axis name → index; default
    every axis 0: rank 0) without a process group: one
    ``AbstractSeqGroup`` per axis (and the batch axes together,
    ``group_axes``) at the rank's place in its line, and ``mesh_coords``
    answering ``coords``.  ``Placement``, the serving step builders and
    ``models.tp`` then run unchanged, on meta tensors
    (``repro_torch.launch.dryrun``)."""
    global _CURRENT, _COORDS
    from repro_torch.core.seq_group import (AbstractSeqGroup,
                                            register_seq_group)
    if _CURRENT is not None:
        raise RuntimeError("this process already joined a mesh")
    coords = {a: int((coords or {}).get(a, 0)) for a in mesh.axis_names}
    rank = int(mesh.devices[tuple(coords[a] for a in mesh.axis_names)])
    for axes in group_axes(mesh):
        line = next(ln for ln in mesh.lines(axes) if rank in ln)
        register_seq_group(AbstractSeqGroup(group_name(axes),
                                            line.index(rank), len(line),
                                            ranks=line))
    _CURRENT, _COORDS = mesh, coords
    return mesh


def leave_mesh() -> None:
    """Unregister the mesh's groups (the process group stays)."""
    global _CURRENT, _COORDS
    from repro_torch.core.seq_group import unregister_seq_group
    if _CURRENT is not None:
        for axes in group_axes(_CURRENT):
            unregister_seq_group(group_name(axes))
    _CURRENT, _COORDS = None, None


def get_abstract_mesh() -> Optional[Mesh]:
    """The mesh this process joined (``set_mesh``), or None."""
    return _CURRENT


def mesh_groups() -> list:
    """The seq groups this rank joined with its mesh, in ``group_axes``'
    order."""
    from repro_torch.core.seq_group import get_seq_group
    if _CURRENT is None:
        raise RuntimeError("this process joined no mesh (set_mesh)")
    return [get_seq_group(group_name(axes)) for axes in group_axes(_CURRENT)]


def mesh_coords() -> Dict[str, int]:
    """This rank's coordinates in the mesh it joined (``join_abstract``'s
    coordinates for an abstract join)."""
    import torch.distributed as dist
    if _CURRENT is None:
        raise RuntimeError("this process joined no mesh (set_mesh)")
    if _COORDS is not None:
        return dict(_COORDS)
    return _CURRENT.coords(dist.get_rank())
