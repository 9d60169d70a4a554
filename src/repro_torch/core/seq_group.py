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
the result back to the card.  The ring executor's point-to-point
transfers (``ring_shift``: gloo ``isend``/``irecv`` to the next and from
the previous rank) are staged the same way and return a handle, so the
card can compute while the bytes travel.  ``shift`` is the one-way
point-to-point transfer of PRISM's halo exchange (``jax.lax.ppermute``
over ``i → i + sft``), staged the same way.  On one card several ranks
share it.  NCCL's device-side gather (the ``direct`` link, one card per
rank) is ROADMAP queue 1 item 7.

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
    """What the staged collectives of one rank moved and cost.  Each
    collective books the bytes it received from peers under one kind."""
    calls: int = 0
    payload_bytes: int = 0    # exchanged K/V (or means)
    meta_bytes: int = 0       # masks and counts
    merge_bytes: int = 0      # sharded decode's (o·l, m, l) partials
    cache_bytes: int = 0      # prompt K/V moved to the rank owning its
                              # cache slots (single-pass PRISM prefill)
    output_bytes: int = 0     # logits gathered or broadcast
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
        self._tag = 0                   # next point-to-point message tag

    def reset_stats(self) -> None:
        self.stats = GatherStats()

    def _begin(self, t: torch.Tensor) -> float:
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
        return time.perf_counter()

    def _end(self, t0: float, kind: str, received: int) -> None:
        field = f"{kind}_bytes"            # a GatherStats field
        setattr(self.stats, field, getattr(self.stats, field) + received)
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

    def all_gather(self, t: torch.Tensor, *, kind: str = "payload"
                   ) -> torch.Tensor:
        """Every rank's ``t`` stacked in rank order → ``[P, *t.shape]`` on
        t's device; the bytes received are booked under ``kind``."""
        t0 = self._begin(t)
        host = self._to_host(t)
        parts = [torch.empty_like(host) for _ in range(self.world_size)]
        dist.all_gather(parts, host)
        out = torch.stack(parts).view(t.dtype).reshape(
            self.world_size, *t.shape).to(t.device)
        self._end(t0, kind, host.numel() * (self.world_size - 1))
        return out

    def all_gather_packed(self, tensors: List[torch.Tensor], *,
                          kind: str = "payload") -> List[torch.Tensor]:
        """Every rank's ``tensors`` (any dtypes and shapes, the same on
        every rank) in one gather: their bytes go out concatenated and come
        back split by offsets → one ``[P, *t.shape]`` tensor each, on the
        first tensor's device; the bytes received are booked under
        ``kind`` as one call."""
        flat = [t.contiguous().reshape(-1).view(torch.uint8)
                for t in tensors]
        got = self.all_gather(torch.cat(flat), kind=kind)    # [P, total]
        out, off = [], 0
        for t, f in zip(tensors, flat):
            part = got[:, off:off + f.numel()].contiguous()
            out.append(part.view(t.dtype).reshape(self.world_size,
                                                  *t.shape))
            off += f.numel()
        return out

    def ring_shift(self, t: torch.Tensor, *, kind: str = "payload",
                   chunks: int = 1) -> "RingTransfer":
        """Start sending ``t`` to rank ``(rank+1) % P`` and receiving the
        same shape and dtype from rank ``(rank-1) % P`` (gloo
        ``isend``/``irecv`` on host buffers, pinned for a CUDA tensor,
        viewed as bytes).  The bytes go as ``chunks`` messages of equal
        size, each with its own tag.  Returns at once: the card may compute
        while the transfer runs, and :meth:`RingTransfer.wait` gives the
        received tensor on t's device.  One call is booked per transfer,
        its received bytes under ``kind`` when it is waited on."""
        t0 = self._begin(t)
        return self._post(self._to_host(t), t, kind, chunks, t0,
                          *self._ring_peers())

    def ring_forward(self, prev: "RingTransfer", *,
                     chunks: int = 1) -> "RingTransfer":
        """Pass on what ``prev`` (waited on) received, from its host
        buffer: no copy off the card and no wait for it."""
        return self._post(prev.host, prev.like, prev.kind, chunks,
                          time.perf_counter(), *self._ring_peers())

    def _ring_peers(self):
        P = self.world_size
        return (self.rank + 1) % P, (self.rank - 1) % P

    def shift(self, t: torch.Tensor, sft: int, *,
              kind: str = "payload") -> torch.Tensor:
        """Rank i sends ``t`` to rank ``i + sft`` and receives the same
        shape and dtype from rank ``i − sft``, where those ranks exist (the
        JAX package's ``ppermute`` over ``[(i, i + sft) for i in
        range(P − sft)]``); a rank with no source gets zeros.  Staged as
        the ring's transfer, one message; one call is booked, with the
        bytes received under ``kind``."""
        P = self.world_size
        if not 0 < sft < P:
            raise ValueError(f"shift {sft} outside 1..{P - 1} for {P} ranks")
        t0 = self._begin(t)
        dst, src = self.rank + sft, self.rank - sft
        return self._post(self._to_host(t), t, kind, 1, t0,
                          dst if dst < P else None,
                          src if src >= 0 else None).wait()

    def _post(self, host, like, kind, chunks, t0, dst: Optional[int],
              src: Optional[int]) -> "RingTransfer":
        """Send ``host``'s bytes to rank ``dst`` and receive as many from
        rank ``src`` (None: no such message; the receive then holds
        zeros), as ``chunks`` messages of equal size."""
        n = chunks if chunks > 1 and host.numel() % chunks == 0 else 1
        alloc = torch.zeros if src is None else torch.empty
        recv = alloc(host.shape, dtype=torch.uint8, pin_memory=like.is_cuda)
        size = host.numel() // n
        tags = range(self._tag, self._tag + n)
        self._tag += n                  # every rank counts alike (SPMD)
        # every receive is posted before any send
        works = [] if src is None else [
            dist.irecv(recv[i * size:(i + 1) * size], src, tag=tag)
            for i, tag in enumerate(tags)]
        works += [] if dst is None else [
            dist.isend(host[i * size:(i + 1) * size], dst, tag=tag)
            for i, tag in enumerate(tags)]
        self.stats.seconds += time.perf_counter() - t0
        return RingTransfer(self, works, host, recv, like, kind,
                            received=0 if src is None else host.numel())

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank (same shape and dtype
        everywhere), on t's device; a receiving rank books its bytes as
        ``output`` (the model outputs broadcast from the rank holding
        them)."""
        t0 = self._begin(t)
        host = self._to_host(t)
        dist.broadcast(host, src)
        out = host.view(t.dtype).reshape(t.shape).to(t.device)
        self._end(t0, "output", 0 if self.rank == src else host.numel())
        return out

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """Rank ``src``'s picklable ``obj`` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src)
        return box[0]

    def all_gather_object(self, obj: Any) -> List[Any]:
        """Every rank's picklable ``obj``, in rank order, on every rank."""
        out: List[Any] = [None] * self.world_size
        dist.all_gather_object(out, obj)
        return out


class RingTransfer:
    """One ring transfer in flight (:meth:`SeqGroup.ring_shift`)."""

    def __init__(self, group: SeqGroup, works, sent, host, like, kind,
                 received: int):
        self.group, self.works, self.sent = group, works, sent
        self.host, self.like, self.kind = host, like, kind
        self.received = received

    def wait(self) -> torch.Tensor:
        """Block until every message of the transfer is through → the
        received tensor on the sent tensor's device (the copy onto the card
        is queued on its stream, behind the work already there)."""
        t0 = time.perf_counter()
        for w in self.works:
            w.wait()
        like = self.like
        out = self.host.view(like.dtype).reshape(like.shape).to(
            like.device, non_blocking=True)
        self.group._end(t0, self.kind, self.received)
        return out


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
