"""Atomic, rotating checkpoints of a tree of tensors (numpy ``.npz``
shards).

Port of ``repro.checkpoint.manager``, with its on-disk layout:
``<dir>/step_XXXXXXXX/manifest.json`` (the step and every leaf's shape and
dtype) beside ``shards_00000.npz``, whose keys are the leaves' key paths
joined by ``/`` and stored with ``__`` in its place; numpy cannot hold
bfloat16, so a bf16 leaf is stored as its ``uint16`` bit pattern with
``"bfloat16"`` in the manifest.  A tree of one structure therefore saves
and loads across the two packages (key paths as ``jax.tree_util`` names
them: dict keys, sequence indices, ``.field`` of a NamedTuple; see
``repro_torch.utils.tree``).

* writes go to ``step_XXXXXXXX.tmp<process>`` and are published with one
  ``os.replace``, so a reader never sees half a checkpoint;
* ``save_async`` copies the tensors to host memory at once and writes the
  files on a thread, so the next step overlaps the write;
* rotation keeps the newest ``keep`` checkpoints.

One process writes every leaf (``process_index`` 0).  A seq group keeps a
full replica of the state on every rank; a mesh's ranks gather their
shards of each leaf and rank 0 writes the global arrays, in the JAX layout
(``Placement.save``), and ``restore(..., placements=)`` hands each rank
its slices of them under a new plan, which is how a re-meshed run resumes
(``runtime.elastic``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves_with_paths, tree_map, \
    tree_unflatten_like

# numpy cannot hold these torch dtypes: stored as a same-width integer view
# under the dtype names the JAX package writes
_VIEW_AS = {torch.bfloat16: ("bfloat16", np.uint16, torch.int16)}
_BY_NAME = {name: (dt, np_dt, tview)
            for dt, (name, np_dt, tview) in _VIEW_AS.items()}


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _to_storable(t: torch.Tensor):
    """(numpy array to store, the dtype name for the manifest)."""
    t = t.detach().cpu()
    if t.dtype in _VIEW_AS:
        name, np_dt, tview = _VIEW_AS[t.dtype]
        return t.contiguous().view(tview).numpy().view(np_dt), name
    arr = t.numpy()
    return arr, arr.dtype.name


def _from_storable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _BY_NAME:
        dt, np_dt, tview = _BY_NAME[dtype_name]
        return torch.from_numpy(np.ascontiguousarray(arr).view(np_dt)
                                .view(np.int16).copy()).view(dt)
    return torch.from_numpy(np.array(arr, copy=True))


def save_pytree(tree, directory: str, step: int,
                process_index: int = 0) -> str:
    """Write one checkpoint atomically; returns the final path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp{process_index}"
    os.makedirs(tmp, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    manifest: Dict[str, Any] = {"step": step, "leaves": {}}
    for path, leaf in tree_leaves_with_paths(tree):
        key = _key(path)
        stored, dtype_name = _to_storable(torch.as_tensor(leaf))
        arrays[key.replace("/", "__")] = stored
        manifest["leaves"][key] = {"shape": list(stored.shape),
                                   "dtype": dtype_name}
    np.savez(os.path.join(tmp, f"shards_{process_index:05d}.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, final)          # atomic publish
    return final


def load_pytree(template, directory: str, step: Optional[int] = None,
                device=None, placements: Optional[Dict[str, tuple]] = None):
    """Restore into the structure of ``template``: each leaf on
    ``device``, or on the device of the template's leaf.  ``placements``
    (a leaf's ``/``-joined key path → a tuple of slices) restores only
    those slices of the stored global arrays: one rank's blocks under a
    new sharding plan (``Placement.state_placements``); a leaf it does not
    name comes whole."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    stored: Dict[str, torch.Tensor] = {}
    for fn in sorted(os.listdir(path)):
        if fn.startswith("shards_") and fn.endswith(".npz"):
            with np.load(os.path.join(path, fn)) as z:
                for k in z.files:
                    key = k.replace("__", "/")
                    dtype_name = manifest["leaves"].get(key, {}).get(
                        "dtype", str(z[k].dtype))
                    stored[key] = _from_storable(z[k], dtype_name)
    leaves = []
    for p, leaf in tree_leaves_with_paths(template):
        key = _key(p)
        if key not in stored:
            raise KeyError(f"checkpoint missing leaf {key}")
        dev = device if device is not None else getattr(leaf, "device",
                                                        "cpu")
        t = stored[key]
        if placements is not None and key in placements:
            t = t[placements[key]].clone()
        leaves.append(t.to(dev))
    return tree_unflatten_like(template, leaves)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and "tmp" not in d]
    return max(steps) if steps else None


class CheckpointManager:
    """Rotation + async writes + restore-or-none."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._pending: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, tree, step: int) -> str:
        path = save_pytree(tree, self.dir, step)
        self._rotate()
        return path

    def save_async(self, tree, step: int) -> None:
        """Device→host copy happens now; disk write on a worker thread."""
        self.wait()
        host_tree = tree_map(lambda t: t.detach().to("cpu", copy=True), tree)
        self._pending = threading.Thread(
            target=lambda: (save_pytree(host_tree, self.dir, step),
                            self._rotate()))
        self._pending.start()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def restore(self, template, step: Optional[int] = None, device=None,
                placements: Optional[Dict[str, tuple]] = None):
        return load_pytree(template, self.dir, step, device, placements)

    def restore_or_none(self, template, device=None):
        try:
            return self.restore(template, device=device)
        except (FileNotFoundError, KeyError):
            return None

    def _rotate(self) -> None:
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                       if d.startswith("step_") and "tmp" not in d)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    @property
    def latest(self) -> Optional[int]:
        return latest_step(self.dir)
