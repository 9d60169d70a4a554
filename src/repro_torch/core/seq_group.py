"""Sequence-partition process groups: the port's counterpart of the JAX
package's mesh axis + ``shard_map`` (``repro.utils.compat``) and of
``repro.core.exchange.all_gather_grad_safe`` (forward only: serving needs
no backward).

Layout: SPMD, as in the paper's prototype.  Each rank is one process that
holds its own partition ``[B, N/P, ...]`` of the sequence; no process ever
holds the global array that JAX's ``shard_map`` slices.  A model forward
under a seq group is therefore called on every rank, with the same inputs,
and each rank keeps its slice of the activations.

Transport: gloo, staged through host memory, the paper's measured path
(``repro_torch.transport.links.StagedLink``): a rank copies the tensor it
sends from the card to pinned host memory, gathers over gloo, and copies
the result back to the card.  On one card several ranks share it.  NCCL's
device-side gather (the ``direct`` link, one card per rank) is ROADMAP
queue 1 item 7.

A process registers its group under the mesh axis name that
``ExchangeConfig.seq_axis`` carries (``"seq"`` by default), and the
exchange code looks it up by that name, as ``shard_map`` bodies name
their axis::

    def rank_main(rank, world_size):        # runs in each spawned rank
        group = get_seq_group("seq")
        ...
    results = spawn(rank_main, 2)           # one result per rank
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass
class GatherStats:
    """What the staged collectives of one rank moved and cost."""
    calls: int = 0
    payload_bytes: int = 0    # exchanged K/V (or means) received from peers
    meta_bytes: int = 0       # masks and counts received from peers
    seconds: float = 0.0      # host clock inside the collectives, staging
                              # copies included (the card is synchronised
                              # before the clock starts)


class SeqGroup:
    """One rank's view of a sequence-partition group (gloo, host-staged)."""

    def __init__(self, axis: str, rank: int, world_size: int):
        self.axis = axis
        self.rank = rank
        self.world_size = world_size
        self.stats = GatherStats()

    def reset_stats(self) -> None:
        self.stats = GatherStats()

    def _begin(self, t: torch.Tensor) -> float:
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
        return time.perf_counter()

    def _end(self, t0: float) -> None:
        self.stats.calls += 1
        self.stats.seconds += time.perf_counter() - t0

    @staticmethod
    def _to_host(t: torch.Tensor) -> torch.Tensor:
        """t's bytes in (pinned, for a CUDA tensor) host memory, flat."""
        flat = t.contiguous().reshape(-1)
        host = torch.empty(flat.shape, dtype=flat.dtype,
                           pin_memory=flat.is_cuda)
        host.copy_(flat)
        return host.view(torch.uint8)

    def all_gather(self, t: torch.Tensor, *, meta: bool = False
                   ) -> torch.Tensor:
        """Every rank's ``t`` stacked in rank order → ``[P, *t.shape]`` on
        t's device.  ``meta`` books the bytes under ``meta_bytes`` (masks,
        counts) instead of ``payload_bytes``."""
        t0 = self._begin(t)
        host = self._to_host(t)
        parts = [torch.empty_like(host) for _ in range(self.world_size)]
        dist.all_gather(parts, host)
        out = torch.stack(parts).view(t.dtype).reshape(
            self.world_size, *t.shape).to(t.device)
        received = host.numel() * (self.world_size - 1)
        if meta:
            self.stats.meta_bytes += received
        else:
            self.stats.payload_bytes += received
        self._end(t0)
        return out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank (same shape and dtype
        everywhere), on t's device."""
        t0 = self._begin(t)
        host = self._to_host(t)
        dist.broadcast(host, src)
        out = host.view(t.dtype).reshape(t.shape).to(t.device)
        self._end(t0)
        return out

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """Rank ``src``'s picklable ``obj`` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src)
        return box[0]


_GROUPS: Dict[str, SeqGroup] = {}    # per process, like torch.distributed's
                                     # own default group


def init_seq_group(rank: int, world_size: int, store_path: str,
                   axis: str = "seq") -> SeqGroup:
    """Join the gloo group of ``world_size`` ranks that rendezvous at the
    file ``store_path`` and register it under ``axis``."""
    if axis in _GROUPS:
        raise RuntimeError(f"seq group {axis!r} already initialised in "
                           f"this process")
    if not dist.is_initialized():
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world_size)
    group = SeqGroup(axis, rank, world_size)
    _GROUPS[axis] = group
    return group


def get_seq_group(axis: str) -> SeqGroup:
    try:
        return _GROUPS[axis]
    except KeyError:
        raise RuntimeError(
            f"no seq group for mesh axis {axis!r} in this process: run the "
            f"partitioned plan on every rank of a group made with "
            f"init_seq_group (or repro_torch.core.seq_group.spawn)"
        ) from None


def has_seq_group(axis: Optional[str]) -> bool:
    return axis in _GROUPS


def destroy_seq_group(axis: str = "seq") -> None:
    _GROUPS.pop(axis, None)
    if not _GROUPS and dist.is_initialized():
        dist.destroy_process_group()


def _rank_entry(fn, rank, world_size, store_path, axis, results, args):
    torch.set_num_threads(1)
    try:
        init_seq_group(rank, world_size, store_path, axis)
        out = fn(rank, world_size, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        destroy_seq_group(axis)


def spawn(fn: Callable, world_size: int, *args, timeout: float = 120.0,
          axis: str = "seq") -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` fresh
    processes (``spawn`` start method), each joined to one seq group under
    ``axis``; return their results in rank order.

    ``fn`` must be importable by name and its result picklable (numpy
    arrays, not tensors).  Raises ``RuntimeError`` with the rank's
    traceback if any rank fails, and ``TimeoutError`` if the ranks have not
    all finished within ``timeout`` seconds; either way every rank process
    is ended before it returns."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="seq_group_")
    store_path = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world_size, store_path, axis, results,
                               args), daemon=True)
             for r in range(world_size)]
    out: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"seq group of {world_size} ranks did not "
                                   f"finish in {timeout:g} s (ranks done: "
                                   f"{sorted(out)})")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no "
                                       f"result") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return [out[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
