"""Sequence-partition process groups: the port's counterpart of the JAX
package's mesh axis + ``shard_map`` (``repro.utils.compat``) and of
``repro.core.exchange.all_gather_grad_safe``.

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
over ``i → i + sft``), staged the same way.  ``pass_on`` is the chain of
the recurrent families' state hand-off: rank p receives from p − 1, works,
and sends to p + 1 (P − 1 messages a hand-off across the group).  On one
card several ranks share it.  NCCL's device-side gather (the ``direct``
link, one card per rank) is ROADMAP queue 1 item [7.6].

Gradients: every staged collective that a training path reaches is
differentiable, and each backward is the transpose of its forward, as
JAX's transpose of the collective it stands for:

* ``all_gather`` (and the moe routing call and the exchanges' gathers
  that use it), as ``all_gather_grad_safe``: the cotangent is
  reduce-scattered in f32 (gloo ``reduce_scatter``); each rank receives
  the sum over ranks of the cotangent of its own slot;
* ``all_gather_packed``: a reduce-scatter of the f32 cotangents of its
  floating-point pieces in one call (int8/int4 scales, topk values);
  integer pieces (codes, indices) carry no gradient;
* ``shift`` (``ppermute``): the cotangent goes back the way the data came,
  from rank p + sft to rank p; a rank that received zeros sends nothing;
* ``ring_shift`` / ``ring_forward``: the cotangent of each received block
  goes back along the ring, to the rank it came from, chunk for chunk;
* ``pass_on``: the reverse chain P − 1 → … → 0.  Rank p's send waits for
  the cotangent of its state from rank p + 1; its receive posts the
  cotangent of the state it received to rank p − 1 without waiting (the
  next collective, or ``flush``, waits for it); f32, in the layout of the
  flat state bytes;
* ``broadcast``: the cotangents summed onto ``src`` (gloo ``reduce``).

Tensor parallelism over a mesh row (``copy_to``, ``reduce_from``,
``gather_from``, ``gather_to``: Megatron's f / g pair and two gathers) is
four autograd functions, each its forward's transpose, staged in f32
(``gather_from`` and ``gather_to`` forward in t's dtype) and booked under
the kind ``tp`` (their backwards too):

* ``copy_to``: the identity forward (the input of a column-parallel
  matmul, the same on every rank of the row); the backward sums the
  cotangent over the row;
* ``reduce_from``: the sum over the row forward (a row-parallel matmul's
  partial products); the identity backward;
* ``gather_from``: every rank's slice joined on the last dim forward (the
  vocab-parallel logits); the backward keeps the rank's slice;
* ``gather_to``: the same forward, for a consumer that is itself split
  over the row (Mamba's ``dt`` from every inner channel, MLA's latents
  before the heads): the backward reduce-scatters the cotangent (each
  rank's part of it summed over the row, the rank's slice kept).

Rematerialised layers (``repro_torch.models.remat``) run their forward
twice, the second time in the backward.  A ``Tape`` keeps that second run
off the wire: inside ``taping(tape)`` the forward collectives record their
outputs on the tape the first time and hand them back in the same order
every later time, sending nothing, taking no tag and booking nothing.
One collective is never taped: ``gather_blocks``, ZeRO-3's gather of a
layer's parameter blocks over the batch axes (or the row), which the
recompute sends again, so that the checkpoint keeps the blocks and not
the gathered layer; its backward reduce-scatters the layer's gradient
(``grad``) as the backward leaves the layer.  It runs on the batch-axes
group, on which every rank builds the same graph, so the forward's,
the recompute's and the backward's calls meet in the same order.

Every backward books its received bytes under the kind ``grad`` and one
call.  Backward collectives run in autograd's order, which is the same on
every rank because every rank builds the same graph; point-to-point
backward messages take tags reserved in the forward, so they match on
every rank.  ``all_reduce`` sums tensors over the ranks in f32 (the
parameter gradients of a training step, packed into buckets), booked as
``grad``; it alone has no backward and raises when an input requires
grad: it sums gradients and is never differentiated.

A process registers its group under the mesh axis name that
``ExchangeConfig.seq_axis`` carries (``"seq"`` by default), and the
exchange code looks it up by that name, as ``shard_map`` bodies name
their axis::

    def rank_main(rank, world_size):        # runs in each spawned rank
        group = get_seq_group("seq")
        ...
    results = spawn(rank_main, 2)           # one result per rank

A group need not be the world: on a mesh (``spawn_mesh``,
``repro_torch.launch.mesh.set_mesh``) each rank belongs to one group a
mesh axis, a line of the grid with a gloo process group of its own
(``SeqGroup.pg``).  Every collective passes that group, every
point-to-point call and root takes the peer's global rank
(``SeqGroup.peer``), and each group counts its own tags, so a row's
exchanges and their backwards stay on the row.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import multiprocessing
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Tuple)

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
    state_bytes: int = 0      # recurrent states handed on by the rank
                              # before (the hybrid and ssm families)
    grad_bytes: int = 0       # gradients: the gather's reduce-scattered
                              # cotangents and the summed parameter
                              # gradients (f32)
    param_bytes: int = 0      # parameter shards gathered over a mesh axis
                              # (ZeRO-3: a layer as the model reaches it,
                              # again in its recompute; after an update)
    tp_bytes: int = 0         # tensor parallelism over the model axis: the
                              # row-parallel partial sums, the vocab-
                              # parallel logits and their cotangents
    halo_calls: int = 0       # ``shift`` calls (PRISM's halo), every rank
    state_calls: int = 0      # ``pass_on`` hand-offs, every rank
    seconds: float = 0.0      # host clock inside the collectives, staging
                              # copies included (the card is synchronised
                              # before the clock starts)


BUCKET_BYTES = 1 << 28        # all_reduce's f32 staging bucket, and a
                              # gather_blocks call's (each way)

_NO_BACKWARD = ("has no backward: it sums gradients after the backward "
                "pass and is never differentiated")


class _StagedGather(torch.autograd.Function):
    """``SeqGroup.all_gather`` with the backward of the JAX package's
    ``all_gather_grad_safe``: the cotangent ``[P, *t.shape]`` is
    reduce-scattered in f32, and each rank gets the sum over ranks of its
    own slot, in t's dtype."""

    @staticmethod
    def forward(ctx, group, t, kind):
        ctx.group, ctx.dtype = group, t.dtype
        return group._gather(t, kind)

    @staticmethod
    def backward(ctx, ct):
        return None, ctx.group.reduce_scatter(ct).to(ctx.dtype), None


class _PackedGather(torch.autograd.Function):
    """``SeqGroup.all_gather_packed`` with its transpose: the f32
    cotangents of the floating-point pieces, ``[P, ...]`` each, are
    reduce-scattered in one call; integer pieces take no gradient."""

    @staticmethod
    def forward(ctx, group, kind, *tensors):
        ctx.group = group
        ctx.like = [(t.dtype, t.shape) for t in tensors]
        outs = group._gather_packed(list(tensors), kind)
        ctx.mark_non_differentiable(
            *[o for o in outs if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *cts):
        g, P = ctx.group, ctx.group.world_size
        floats = [i for i, (dt, _) in enumerate(ctx.like)
                  if dt.is_floating_point]
        got = g.reduce_scatter(torch.cat(
            [cts[i].float().reshape(P, -1) for i in floats], dim=1))
        out: List[Optional[torch.Tensor]] = [None] * len(ctx.like)
        off = 0
        for i in floats:
            dtype, shape = ctx.like[i]
            n = shape.numel()
            out[i] = got[off:off + n].reshape(shape).to(dtype)
            off += n
        return (None, None, *out)


class _GatherBlocks(torch.autograd.Function):
    """``SeqGroup.gather_blocks``: the pieces of every rank in one staged
    gather (``param``; one a ``BUCKET_BYTES`` bucket), each joined along
    its dim; the backward reduce-scatters the f32 cotangents of the pieces
    marked ``sums`` in one call a bucket (``grad``) and keeps the rank's
    own block of the others'."""

    @staticmethod
    def forward(ctx, group, dims, sums, *pieces):
        ctx.group, ctx.dims, ctx.sums = group, dims, sums
        ctx.like = [(t.dtype, t.shape) for t in pieces]
        return tuple(group._gather_joined(list(pieces), dims))

    @staticmethod
    def backward(ctx, *cts):
        g, P = ctx.group, ctx.group.world_size
        device = next(c for c in cts if c is not None).device
        out: List[Optional[torch.Tensor]] = [None] * len(cts)
        for bucket in _buckets(ctx.like):
            parts, summed = [], []
            for i in bucket:
                dtype, shape = ctx.like[i]
                d, ct = ctx.dims[i], cts[i]
                if ct is None:
                    ct = torch.zeros(_joined_shape(shape, d, P), dtype=dtype,
                                     device=device)
                slots = list(ct.unbind(0)) if d is None else \
                    list(ct.chunk(P, d))
                if ctx.sums[i]:
                    parts.append(torch.stack([c.float() for c in slots])
                                 .reshape(P, -1))
                    summed.append(i)
                else:
                    out[i] = slots[g.rank].contiguous()
            if not parts:
                continue
            got = g.reduce_scatter(torch.cat(parts, dim=1))
            del parts
            off = 0
            for i in summed:
                dtype, shape = ctx.like[i]
                out[i] = got[off:off + shape.numel()].reshape(shape).to(dtype)
                off += shape.numel()
        return (None, None, None, *out)


def _buckets(like: List[Tuple[torch.dtype, torch.Size]]) -> List[List[int]]:
    """The indices of pieces of (dtype, shape) ``like``, largest elements
    first, in buckets of at most ``BUCKET_BYTES`` (a larger piece alone):
    ``gather_blocks``' calls each way."""
    out: List[List[int]] = []
    size = 0
    for i in sorted(range(len(like)), key=lambda i: -like[i][0].itemsize):
        n = like[i][1].numel() * like[i][0].itemsize
        if not out or size + n > BUCKET_BYTES:
            out.append([])
            size = 0
        out[-1].append(i)
        size += n
    return out


def _joined_shape(shape, dim: Optional[int], P: int) -> Tuple[int, ...]:
    """The shape of P blocks of ``shape`` joined along ``dim`` (None:
    stacked on a new leading dim)."""
    if dim is None:
        return (P, *shape)
    out = list(shape)
    out[dim] *= P
    return tuple(out)


class _Shift(torch.autograd.Function):
    """``SeqGroup.shift`` with its transpose (``ppermute``'s): the
    cotangent of what rank i received goes back to rank i − sft, and rank
    i's input gets what rank i + sft sends back (zeros where that rank
    does not exist)."""

    @staticmethod
    def forward(ctx, group, t, sft, kind, tag):
        ctx.group, ctx.sft, ctx.tag = group, sft, tag
        return group._shift(t, group.rank + sft, group.rank - sft, kind)

    @staticmethod
    def backward(ctx, ct):
        g, sft = ctx.group, ctx.sft
        return (None, g._shift(ct, g.rank - sft, g.rank + sft, "grad",
                               tag=ctx.tag), None, None, None)


class _RingLink(torch.autograd.Function):
    """One ring transfer, already waited on: ``sent`` (what this rank sent
    to rank p + 1) → ``received`` (what it got from rank p − 1).  The
    backward is the transfer reversed: the cotangent of ``received`` goes
    back to rank p − 1 in the forward's chunks, and rank p + 1's comes in
    as the cotangent of ``sent``."""

    @staticmethod
    def forward(ctx, group, sent, received, chunks, tag):
        ctx.group, ctx.chunks, ctx.tag = group, chunks, tag
        return received

    @staticmethod
    def backward(ctx, ct):
        g = ctx.group
        P = g.world_size
        t0 = g._begin(ct)
        back = g._post(g._to_host(ct), ct, "grad", ctx.chunks, t0,
                       (g.rank - 1) % P, (g.rank + 1) % P, tag=ctx.tag)
        return None, back.wait(), None, None, None


class _ChainReceived(torch.autograd.Function):
    """The state rank p received in ``pass_on``, as leaves shaped as
    ``like``, tied to ``anchor`` (a tensor of this rank's graph, so the
    node runs in the backward).  The backward sends the leaves' cotangents,
    f32 and flat in ``like``'s order, to rank p − 1 without waiting; it
    gives ``anchor`` nothing."""

    @staticmethod
    def forward(ctx, group, tag, like, buf, anchor):
        ctx.group, ctx.tag = group, tag
        return tuple(t.clone() for t in unpack_leaves(buf, like).values())

    @staticmethod
    def backward(ctx, *cts):
        ctx.group._chain_send(torch.cat([c.float().reshape(-1) for c in cts]),
                              ctx.tag)
        return None, None, None, None, None


class _ChainSent(torch.autograd.Function):
    """``out`` of rank p's ``pass_on``, tied to the ``final`` state it sent
    to rank p + 1.  The backward passes ``out``'s cotangent through and
    waits for the f32 cotangent of ``final`` from rank p + 1 (one ``grad``
    call)."""

    @staticmethod
    def forward(ctx, group, tag, out, *final):
        ctx.group, ctx.tag = group, tag
        ctx.like = [(t.dtype, t.shape) for t in final]
        return out

    @staticmethod
    def backward(ctx, ct_out, *_):
        n = sum(shape.numel() for _, shape in ctx.like)
        got = ctx.group._chain_recv(n, ct_out.device, ctx.tag)
        out, off = [], 0
        for dtype, shape in ctx.like:
            out.append(got[off:off + shape.numel()].reshape(shape).to(dtype))
            off += shape.numel()
        return (None, None, ct_out, *out)


class _CopyTo(torch.autograd.Function):
    """``SeqGroup.copy_to``: the identity forward; the backward sums the
    cotangent over the group (``tp``)."""

    @staticmethod
    def forward(ctx, group, t):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, ct):
        return None, ctx.group._tp_sum(ct)


class _ReduceFrom(torch.autograd.Function):
    """``SeqGroup.reduce_from``: the sum over the group forward (``tp``);
    the identity backward."""

    @staticmethod
    def forward(ctx, group, t):
        return group._tp_sum(t)

    @staticmethod
    def backward(ctx, ct):
        return None, ct


class _GatherFrom(torch.autograd.Function):
    """``SeqGroup.gather_from``: every rank's slice joined on the last dim
    (``tp``); the backward keeps the cotangent of the rank's own slice."""

    @staticmethod
    def forward(ctx, group, t):
        ctx.group, ctx.width = group, t.shape[-1]
        return group._tp_gather(t)

    @staticmethod
    def backward(ctx, ct):
        r, w = ctx.group.rank, ctx.width
        return None, ct[..., r * w:(r + 1) * w].contiguous()


class _GatherTo(torch.autograd.Function):
    """``SeqGroup.gather_to``: every rank's slice joined on the last dim
    (``tp``); the backward reduce-scatters the cotangent (``tp``): the sum
    over the group of the cotangents of the rank's slice."""

    @staticmethod
    def forward(ctx, group, t):
        ctx.group, ctx.dtype = group, t.dtype
        return group._tp_gather(t)

    @staticmethod
    def backward(ctx, ct):
        parts = torch.stack(list(ct.chunk(ctx.group.world_size, dim=-1)))
        return None, ctx.group.reduce_scatter(parts, kind="tp").to(ctx.dtype)


class _Broadcast(torch.autograd.Function):
    """``SeqGroup.broadcast`` with its transpose: every rank's cotangent
    summed onto ``src`` in f32 (gloo ``reduce``); the other ranks' inputs
    get none."""

    @staticmethod
    def forward(ctx, group, t, src):
        ctx.group, ctx.src, ctx.dtype = group, src, t.dtype
        return group._broadcast(t, src)

    @staticmethod
    def backward(ctx, ct):
        got = ctx.group._reduce_to(ct, ctx.src)
        return None, None if got is None else got.to(ctx.dtype), None


def pack_leaves(leaves: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The leaves, in key order, as one flat uint8 buffer."""
    return torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      for t in leaves.values()])


def unpack_leaves(buf: torch.Tensor, like: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """``pack_leaves``' inverse: views of ``buf`` shaped and typed as
    ``like``'s leaves."""
    out, off = {}, 0
    for name, t in like.items():
        n = t.numel() * t.element_size()
        out[name] = buf[off:off + n].view(t.dtype).reshape(t.shape)
        off += n
    return out


def leaves_bytes(like: Dict[str, torch.Tensor]) -> int:
    """Bytes of ``pack_leaves`` of leaves shaped as ``like``."""
    return sum(t.numel() * t.element_size() for t in like.values())


class Tape:
    """What the forward collectives of one rematerialised region returned,
    in call order: recorded by its first run, replayed by every later one
    (``SeqGroup.taping``)."""

    def __init__(self):
        self.outs: List[Any] = []
        self.recorded = False      # the first run is over: replay
        self.next = 0              # the next output to replay


class _Kept(NamedTuple):
    """A tensor a tape keeps: detached, and whether it required grad."""
    t: torch.Tensor
    grad: bool


def _frozen(out: Any) -> Any:
    """A collective's output (a tensor, or a list, tuple or dict of them,
    or None) as the tape keeps it."""
    if isinstance(out, torch.Tensor):
        return _Kept(out.detach(), out.requires_grad)
    if isinstance(out, dict):
        return {k: _frozen(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_frozen(v) for v in out)
    return out


def _revived(kept: Any) -> Any:
    """``_frozen``'s output back as tensors for the replay: one that
    required grad comes back as a copy that does (a non-leaf, as the
    collective's own output was), so the recompute saves what the first
    run saved."""
    if isinstance(kept, _Kept):
        return kept.t.detach().requires_grad_().clone() if kept.grad \
            else kept.t
    if isinstance(kept, dict):
        return {k: _revived(v) for k, v in kept.items()}
    if isinstance(kept, (list, tuple)):
        return type(kept)(_revived(v) for v in kept)
    return kept


def _tracked(*tensors) -> bool:
    """Does autograd need a gradient through any of ``tensors``?"""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


class SeqGroup:
    """One rank's view of a sequence-partition group (gloo, host-staged)."""

    def __init__(self, axis: str, rank: int, world_size: int, *,
                 pg=None, ranks: Optional[List[int]] = None):
        self.axis = axis
        self.rank = rank                # this rank's place in the group
        self.world_size = world_size
        self.pg = pg                    # None: the default (world) group
        # global rank of each group rank (a mesh line; the world's own
        # ranks for the default group)
        self.ranks = list(range(world_size)) if ranks is None else \
            list(ranks)
        self.stats = GatherStats()
        self._tag = 0                   # next point-to-point message tag
        # pass_on's sends in flight: (work, host buffer)
        self._sends: List[Tuple[Any, torch.Tensor]] = []
        self._tape: Optional[Tape] = None   # see taping

    @contextlib.contextmanager
    def taping(self, tape: Tape):
        """Inside the block, the forward collectives (``all_gather``,
        ``all_gather_packed``, ``shift``, ``ring_shift`` / ``ring_forward``
        and their waits, ``pass_on``, ``broadcast``) record their outputs
        on ``tape`` the first time the block runs; every later run takes
        them from the tape in the same order and sends nothing, takes no
        tag and books nothing (``pass_on`` still runs its ``fn`` on the
        state it received)."""
        prev, self._tape = self._tape, tape
        tape.next = 0
        try:
            yield
        finally:
            self._tape = prev
            tape.recorded = True

    def peer(self, r: int) -> int:
        """The global rank of group rank ``r`` (what torch.distributed's
        point-to-point calls and roots take)."""
        return self.ranks[r]

    def _replaying(self) -> bool:
        return self._tape is not None and self._tape.recorded

    def _replay(self) -> Any:
        tape = self._tape
        if tape.next >= len(tape.outs):
            raise RuntimeError("a rematerialised region called more "
                               "collectives in its recompute than in its "
                               "forward")
        tape.next += 1
        return _revived(tape.outs[tape.next - 1])

    def _record(self, out: Any) -> Any:
        if self._tape is not None and not self._tape.recorded:
            self._tape.outs.append(_frozen(out))
        return out

    def reset_stats(self) -> None:
        self.stats = GatherStats()

    def _begin(self, t: torch.Tensor) -> float:
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
        self.flush()
        return time.perf_counter()

    def flush(self) -> None:
        """Wait until every message ``pass_on`` sent has been taken (a
        collective does this first; the wait is booked as staged
        seconds)."""
        if self._sends:
            t0 = time.perf_counter()
            for work, _ in self._sends:
                work.wait()
            self._sends.clear()
            self.stats.seconds += time.perf_counter() - t0

    def _take_tags(self, n: int) -> int:
        """The first of ``n`` point-to-point tags (every rank counts alike:
        SPMD)."""
        tag = self._tag
        self._tag += n
        return tag

    def pass_on(self, fn: Callable[[Optional[Dict[str, torch.Tensor]]],
                                   Tuple[Any, Dict[str, torch.Tensor]]],
                like: Dict[str, torch.Tensor], device,
                anchor: Optional[torch.Tensor], *,
                kind: str = "state") -> Any:
        """One hand-off down the chain 0 → 1 → … → P − 1, called on every
        rank: rank p > 0 receives from rank p − 1 the leaves shaped and
        typed as ``like`` (on ``device``; rank 0 receives nothing: None),
        then ``fn(received) → (out, to_send)`` runs, and ``to_send`` (leaves
        as ``like``) goes to rank p + 1 (the last rank sends nothing) →
        out.  P − 1 messages across the group: a receiving rank books one
        call and the bytes under ``kind`` (its wait for the rank before it
        included in the seconds); the send is posted and returns at once
        (staged through host memory, pinned for a CUDA device), and the
        next collective, or :meth:`flush`, waits for it.

        Differentiable where ``anchor`` (a tensor of this rank's graph that
        ``fn`` reads, e.g. the scan's input) requires grad: the received
        leaves then require grad, and the backward runs the chain in
        reverse (see the module's note); ``out`` must be a tensor."""
        if self._replaying():
            return fn(self._replay())[0]
        tag = self._take_tags(2)        # the forward's, then the backward's
        self.stats.state_calls += 1
        grad = _tracked(anchor)
        got = None
        if self.rank > 0:               # (no flush: the chain may pipeline)
            t0 = time.perf_counter()
            nbytes = leaves_bytes(like)
            cuda = torch.device(device).type == "cuda"
            host = torch.empty((nbytes,), dtype=torch.uint8, pin_memory=cuda)
            dist.recv(host, self.peer(self.rank - 1), tag=tag,
                      group=self.pg)
            buf = host.to(device)
            self._end(t0, kind, nbytes)
            if grad:
                got = dict(zip(like, _ChainReceived.apply(
                    self, tag + 1, like, buf, anchor)))
            else:
                got = unpack_leaves(buf, like)
        out, to_send = fn(self._record(got))
        if self.rank < self.world_size - 1:
            t0 = time.perf_counter()
            final = [to_send[name] for name in like]
            host = self._to_host(pack_leaves(dict(zip(like, final))))
            self._sends.append((dist.isend(host, self.peer(self.rank + 1),
                                           tag=tag, group=self.pg), host))
            self.stats.seconds += time.perf_counter() - t0
            if grad and _tracked(*final):
                out = _ChainSent.apply(self, tag + 1, out, *final)
        return out

    def _end(self, t0: float, kind: str, received: int) -> None:
        field = f"{kind}_bytes"            # a GatherStats field
        setattr(self.stats, field, getattr(self.stats, field) + received)
        self.stats.calls += 1
        self.stats.seconds += time.perf_counter() - t0

    @staticmethod
    def _host_copy(t: torch.Tensor, dtype=None) -> torch.Tensor:
        """t (cast to ``dtype``) in (pinned, for a CUDA tensor) host
        memory, flat."""
        flat = t.detach().contiguous().reshape(-1)
        host = torch.empty(flat.shape, dtype=dtype or flat.dtype,
                           pin_memory=flat.is_cuda)
        host.copy_(flat)
        return host

    @classmethod
    def _to_host(cls, t: torch.Tensor) -> torch.Tensor:
        """t's bytes in (pinned, for a CUDA tensor) host memory, flat."""
        return cls._host_copy(t).view(torch.uint8)

    def all_gather(self, t: torch.Tensor, *, kind: str = "payload"
                   ) -> torch.Tensor:
        """Every rank's ``t`` stacked in rank order → ``[P, *t.shape]`` on
        t's device; the bytes received are booked under ``kind``.  Where
        ``t`` requires grad the gather is differentiable (the cotangent
        reduce-scattered in f32, booked as ``grad``)."""
        if self._replaying():
            return self._replay()
        if _tracked(t):
            return self._record(_StagedGather.apply(self, t, kind))
        return self._record(self._gather(t, kind))

    def _gather(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        t0 = self._begin(t)
        host = self._to_host(t)
        parts = [torch.empty_like(host) for _ in range(self.world_size)]
        dist.all_gather(parts, host, group=self.pg)
        out = torch.stack(parts).view(t.dtype).reshape(
            self.world_size, *t.shape).to(t.device)
        self._end(t0, kind, host.numel() * (self.world_size - 1))
        return out

    def reduce_scatter(self, t: torch.Tensor, kind: str = "grad"
                       ) -> torch.Tensor:
        """``t`` ``[P, ...]`` on every rank → the sum over ranks of slot
        ``rank`` ``[...]`` in f32 on t's device (gloo ``reduce_scatter``
        of f32 host buffers); the other ranks' slots received, (P − 1) ×
        the slot's f32 bytes, are booked under ``kind``."""
        P = self.world_size
        if t.shape[0] != P:
            raise ValueError(f"reduce_scatter: leading dim {t.shape[0]} is "
                             f"not the group's {P} ranks")
        t0 = self._begin(t)
        host = self._host_copy(t, torch.float32).reshape(P, -1)
        out = torch.empty(host.shape[1:], dtype=torch.float32,
                          pin_memory=t.is_cuda)
        dist.reduce_scatter(out, list(host.unbind(0)), group=self.pg)
        res = out.reshape(t.shape[1:]).to(t.device)
        self._end(t0, kind, out.numel() * 4 * (P - 1))
        return res

    def all_reduce(self, tensors: List[torch.Tensor], *, kind: str = "grad"
                   ) -> List[torch.Tensor]:
        """The sum over ranks of each tensor, in f32 on its device, the
        same bits on every rank (gloo ``all_reduce``).  The tensors go
        packed into f32 buckets of at most ``BUCKET_BYTES`` (a tensor
        larger than that is a bucket of its own: the pinned staging
        buffers stay that size), one staged call each; each call books
        (P − 1) × its f32 bytes under ``kind``."""
        if _tracked(*tensors):
            raise RuntimeError(f"SeqGroup.all_reduce {_NO_BACKWARD}")
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        bucket: List[int] = []
        size = 0

        def run():
            parts = [tensors[i].detach().float().reshape(-1)
                     for i in bucket]
            flat = parts[0] if len(parts) == 1 else torch.cat(parts)
            got = self._sum_bucket(flat, kind)
            off = 0
            for i in bucket:
                n = tensors[i].numel()
                out[i] = got[off:off + n].reshape(tensors[i].shape)
                off += n

        for i, t in enumerate(tensors):
            nb = t.numel() * 4
            if bucket and size + nb > BUCKET_BYTES:
                run()
                bucket, size = [], 0
            bucket.append(i)
            size += nb
        if bucket:
            run()
        return out

    def _sum_bucket(self, flat: torch.Tensor, kind: str) -> torch.Tensor:
        """One staged f32 ``all_reduce`` of ``flat`` → the sum on its
        device; (P − 1) × its bytes booked under ``kind``."""
        t0 = self._begin(flat)
        host = self._host_copy(flat)
        dist.all_reduce(host, group=self.pg)
        got = host.to(flat.device)
        self._end(t0, kind, host.numel() * 4 * (self.world_size - 1))
        return got

    def _chain_send(self, flat: torch.Tensor, tag: int) -> None:
        """``pass_on``'s backward at a receiving rank: the f32 cotangents
        ``flat`` go to rank p − 1 without waiting (nothing booked but the
        seconds)."""
        t0 = time.perf_counter()
        host = self._host_copy(flat)
        self._sends.append((dist.isend(host, self.peer(self.rank - 1),
                                       tag=tag, group=self.pg), host))
        self.stats.seconds += time.perf_counter() - t0

    def _chain_recv(self, n: int, device, tag: int) -> torch.Tensor:
        """``pass_on``'s backward at a sending rank: the ``n`` f32
        cotangents from rank p + 1 on ``device`` (one ``grad`` call)."""
        t0 = time.perf_counter()
        host = torch.empty((n,), dtype=torch.float32,
                           pin_memory=torch.device(device).type == "cuda")
        dist.recv(host, self.peer(self.rank + 1), tag=tag, group=self.pg)
        got = host.to(device)
        self._end(t0, "grad", n * 4)
        return got

    # --- tensor parallelism over the group (``tp``) -----------------------

    def copy_to(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as it is, the input of a column-parallel region: under
        grad its backward sums the cotangent over the group (each rank
        holds the part of it that its columns give)."""
        if self.world_size == 1 or not _tracked(t):
            return t
        return _CopyTo.apply(self, t)

    def reduce_from(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the group of ``t`` (a row-parallel matmul's partial
        products) in f32, back in t's dtype, the same bits on every rank;
        the identity backward."""
        if self.world_size == 1:
            return t
        if self._replaying():
            return self._replay()
        if _tracked(t):
            return self._record(_ReduceFrom.apply(self, t))
        return self._record(self._tp_sum(t))

    def gather_from(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` joined on the last dim in rank order (the
        vocab-parallel logits → the whole vocabulary); the backward keeps
        the rank's slice of the cotangent."""
        if self.world_size == 1:
            return t
        if self._replaying():
            return self._replay()
        if _tracked(t):
            return self._record(_GatherFrom.apply(self, t))
        return self._record(self._tp_gather(t))

    def gather_to(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` joined on the last dim in rank order (a
        column block whose consumer is split over the group as well: each
        rank's cotangent is its part's only); the backward reduce-scatters
        the cotangent, each rank keeping its slice of the sum."""
        if self.world_size == 1:
            return t
        if self._replaying():
            return self._replay()
        if _tracked(t):
            return self._record(_GatherTo.apply(self, t))
        return self._record(self._tp_gather(t))

    def _tp_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The f32 sum over the group (gloo ``all_reduce``) in t's dtype;
        (P − 1) × the f32 bytes booked as ``tp``."""
        t0 = self._begin(t)
        host = self._host_copy(t, torch.float32)
        dist.all_reduce(host, group=self.pg)
        out = host.reshape(t.shape).to(device=t.device, dtype=t.dtype)
        self._end(t0, "tp", host.numel() * 4 * (self.world_size - 1))
        return out

    def _tp_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` joined on the last dim (``_gather``, booked
        as ``tp``)."""
        parts = self._gather(t.contiguous(), "tp")
        return torch.cat(list(parts.unbind(0)), dim=-1)

    def all_gather_packed(self, tensors: List[torch.Tensor], *,
                          kind: str = "payload") -> List[torch.Tensor]:
        """Every rank's ``tensors`` (any dtypes and shapes, the same on
        every rank) in one gather: their bytes go out concatenated and come
        back split by offsets → one ``[P, *t.shape]`` tensor each, on the
        first tensor's device; the bytes received are booked under
        ``kind`` as one call.  Differentiable in its floating-point
        pieces (the backward: one f32 reduce-scatter of their
        cotangents)."""
        if self._replaying():
            return self._replay()
        if _tracked(*tensors):
            return self._record(list(_PackedGather.apply(self, kind,
                                                         *tensors)))
        return self._record(self._gather_packed(tensors, kind))

    def gather_blocks(self, pieces: List[torch.Tensor],
                      dims: List[Optional[int]], sums: List[bool]
                      ) -> List[torch.Tensor]:
        """A layer's parameter blocks from every rank of the group (ZeRO-3's
        just-in-time gather): ``pieces`` (any dtypes and shapes, the same on
        every rank) go out in one staged gather (one a bucket of
        ``BUCKET_BYTES``, a larger piece alone), and each comes back as
        the ranks' blocks joined in rank order along its ``dims`` entry
        (None: stacked, ``[P, *t.shape]``), written straight from the
        received host buffers into its place (the card holds the gathered
        layer once); booked as ``param``.  Never taped: a rematerialised
        layer gathers its weights again in its recompute (its checkpoint
        keeps the blocks, not the gathered layer).  Differentiable: the
        backward reduce-scatters in one f32 call the cotangents of the
        pieces whose ``sums`` is true (each rank's part of the loss reads
        them: the sum over the group of its block, booked as ``grad``) and
        keeps the rank's own block of the others' (every rank computed the
        same gradient)."""
        if self.world_size == 1:
            return [t if d is not None else t[None]
                    for t, d in zip(pieces, dims)]
        if _tracked(*pieces):
            return list(_GatherBlocks.apply(self, list(dims), list(sums),
                                            *pieces))
        return self._gather_joined(list(pieces), list(dims))

    def _gather_joined(self, pieces: List[torch.Tensor],
                       dims: List[Optional[int]]) -> List[torch.Tensor]:
        """``gather_blocks``' staged calls: the pieces' bytes packed by
        element size (so each piece's offset is a multiple of its own) into
        buckets of at most ``BUCKET_BYTES`` (a larger piece a bucket of its
        own: the host buffers of a call stay that size), one gather over
        gloo a bucket, and each piece's P blocks copied from the host
        buffers into its joined tensor on its device."""
        outs: List[Optional[torch.Tensor]] = [None] * len(pieces)
        for bucket in _buckets([(t.dtype, t.shape) for t in pieces]):
            t0 = self._begin(pieces[bucket[0]])
            flat = [pieces[i].detach().contiguous().reshape(-1)
                    .view(torch.uint8) for i in bucket]
            host = self._to_host(flat[0] if len(flat) == 1
                                 else torch.cat(flat))
            pinned = pieces[bucket[0]].is_cuda
            parts = [torch.empty(host.shape, dtype=host.dtype,
                                 pin_memory=pinned)
                     for _ in range(self.world_size)]
            dist.all_gather(parts, host, group=self.pg)
            off = 0
            for i, f in zip(bucket, flat):
                t, d, n = pieces[i], dims[i], f.numel()
                outs[i] = out = torch.empty(
                    _joined_shape(t.shape, d, self.world_size),
                    dtype=t.dtype, device=t.device)
                for r, part in enumerate(parts):
                    dst = out[r] if d is None else out.narrow(
                        d, r * t.shape[d], t.shape[d])
                    dst.copy_(part[off:off + n].view(t.dtype)
                              .reshape(t.shape))
                off += n
            self._end(t0, "param", host.numel() * (self.world_size - 1))
            del host, parts
        return outs

    def _gather_packed(self, tensors: List[torch.Tensor], kind: str
                       ) -> List[torch.Tensor]:
        flat = [t.detach().contiguous().reshape(-1).view(torch.uint8)
                for t in tensors]
        got = self._gather(torch.cat(flat), kind)            # [P, total]
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
        its received bytes under ``kind`` when it is waited on.  Where
        ``t`` requires grad the received tensor does too, and the
        backward sends its cotangent back to rank ``(rank-1) % P``."""
        if self._replaying():
            return _TapedTransfer(self)
        t0 = self._begin(t)
        return self._post(self._to_host(t), t, kind, chunks, t0,
                          *self._ring_peers(), tracked=t).taped()

    def ring_forward(self, prev: "RingTransfer", *,
                     chunks: int = 1) -> "RingTransfer":
        """Pass on what ``prev`` (waited on) received, from its host
        buffer: no copy off the card and no wait for it.  Differentiable
        as :meth:`ring_shift` (the cotangent of what was passed on comes
        back from rank ``(rank+1) % P``)."""
        if self._replaying():
            return _TapedTransfer(self)
        return self._post(prev.host, prev.like, prev.kind, chunks,
                          time.perf_counter(), *self._ring_peers(),
                          tracked=prev.out).taped()

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
        bytes received under ``kind``.  Differentiable: the backward sends
        the cotangent back from rank i + sft to rank i (``ppermute``'s
        transpose), one ``grad`` call."""
        P = self.world_size
        if not 0 < sft < P:
            raise ValueError(f"shift {sft} outside 1..{P - 1} for {P} ranks")
        if self._replaying():
            return self._replay()
        self.stats.halo_calls += 1
        if _tracked(t):
            return self._record(_Shift.apply(self, t, sft, kind,
                                             self._take_tags(1)))
        return self._record(self._shift(t, self.rank + sft, self.rank - sft,
                                        kind))

    def _shift(self, t: torch.Tensor, dst: int, src: int, kind: str,
               tag: Optional[int] = None) -> torch.Tensor:
        """Send ``t`` to rank ``dst`` and receive as many bytes from rank
        ``src`` (either outside the group: no such message; zeros
        received), one message, waited for."""
        P = self.world_size
        t0 = self._begin(t)
        return self._post(self._to_host(t), t, kind, 1, t0,
                          dst if 0 <= dst < P else None,
                          src if 0 <= src < P else None, tag=tag).wait()

    def _post(self, host, like, kind, chunks, t0, dst: Optional[int],
              src: Optional[int], *, tag: Optional[int] = None,
              tracked: Optional[torch.Tensor] = None) -> "RingTransfer":
        """Send ``host``'s bytes to rank ``dst`` and receive as many from
        rank ``src`` (None: no such message; the receive then holds
        zeros), as ``chunks`` messages of equal size, tagged from ``tag``
        on (default: the next free tags).  ``tracked`` (the tensor whose
        bytes ``host`` holds), where it requires grad, makes the received
        tensor differentiable (``_RingLink``; its backward's tags are
        reserved here)."""
        n = chunks if chunks > 1 and host.numel() % chunks == 0 else 1
        alloc = torch.zeros if src is None else torch.empty
        recv = alloc(host.shape, dtype=torch.uint8, pin_memory=like.is_cuda)
        size = host.numel() // n
        start = self._take_tags(n) if tag is None else tag
        tags = range(start, start + n)
        # every receive is posted before any send
        works = [] if src is None else [
            dist.irecv(recv[i * size:(i + 1) * size], self.peer(src),
                       tag=tg, group=self.pg)
            for i, tg in enumerate(tags)]
        works += [] if dst is None else [
            dist.isend(host[i * size:(i + 1) * size], self.peer(dst),
                       tag=tg, group=self.pg)
            for i, tg in enumerate(tags)]
        self.stats.seconds += time.perf_counter() - t0
        link = ((tracked, n, self._take_tags(n)) if _tracked(tracked)
                else None)
        return RingTransfer(self, works, host, recv, like, kind,
                            received=0 if src is None else host.numel(),
                            link=link)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank (same shape and dtype
        everywhere), on t's device; a receiving rank books its bytes as
        ``output`` (the model outputs broadcast from the rank holding
        them).  Differentiable where ``t`` requires grad on every rank: the
        backward sums every rank's cotangent onto ``src`` (f32, one
        ``grad`` call each rank, the bytes booked on ``src``)."""
        if self._replaying():
            return self._replay()
        if _tracked(t):
            return self._record(_Broadcast.apply(self, t, src))
        return self._record(self._broadcast(t, src))

    def _broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        t0 = self._begin(t)
        host = self._to_host(t)
        dist.broadcast(host, self.peer(src), group=self.pg)
        out = host.view(t.dtype).reshape(t.shape).to(t.device)
        self._end(t0, "output", 0 if self.rank == src else host.numel())
        return out

    def _reduce_to(self, t: torch.Tensor, dst: int) -> Optional[torch.Tensor]:
        """The sum over ranks of ``t`` in f32 on rank ``dst`` (gloo
        ``reduce``; None elsewhere); ``dst`` books (P − 1) × the f32
        bytes as ``grad``, every rank one call."""
        t0 = self._begin(t)
        host = self._host_copy(t, torch.float32)
        dist.reduce(host, self.peer(dst), group=self.pg)
        mine = self.rank == dst
        self._end(t0, "grad", host.numel() * 4 * (self.world_size - 1)
                  if mine else 0)
        return host.reshape(t.shape).to(t.device) if mine else None

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """Rank ``src``'s picklable ``obj`` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, self.peer(src), group=self.pg)
        return box[0]

    def all_gather_object(self, obj: Any) -> List[Any]:
        """Every rank's picklable ``obj``, in rank order, on every rank."""
        out: List[Any] = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self.pg)
        return out


class RingTransfer:
    """One ring transfer in flight (:meth:`SeqGroup.ring_shift`)."""

    def __init__(self, group: SeqGroup, works, sent, host, like, kind,
                 received: int, link=None):
        self.group, self.works, self.sent = group, works, sent
        self.host, self.like, self.kind = host, like, kind
        self.received = received
        self.link = link        # (tracked tensor sent, chunks, backward tag)
        self.out: Optional[torch.Tensor] = None
        self.record = False     # a ring transfer: its wait goes on the tape

    def taped(self) -> "RingTransfer":
        """This transfer, its received tensor recorded on the group's tape
        (if one is recording) when it is waited on."""
        self.record = True
        return self

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
        if self.link is not None:
            tracked, chunks, tag = self.link
            out = _RingLink.apply(self.group, tracked, out, chunks, tag)
        self.out = self.group._record(out) if self.record else out
        return out


class _TapedTransfer:
    """A ring transfer of a rematerialised region's recompute: its wait
    takes the tensor its first run received from the tape."""

    def __init__(self, group: SeqGroup):
        self.group = group
        self.out: Optional[torch.Tensor] = None

    def wait(self) -> torch.Tensor:
        self.out = self.group._replay()
        return self.out


def _counter():
    from repro_torch.launch.hlo_analysis import active_counter
    return active_counter()


@contextlib.contextmanager
def _on_host():
    """Host staging buffers: uncounted by the step counter running."""
    counter = _counter()
    if counter is None:
        yield
        return
    with counter.host():
        yield


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class AbstractSeqGroup(SeqGroup):
    """Rank ``rank`` of a group of ``world_size``, traced without the
    group: every staged primitive returns meta tensors shaped as the real
    call's result, calls no ``torch.distributed`` function and copies
    nothing to the host (``repro_torch.launch.dryrun`` traces one rank of
    a production mesh on the meta device with it).

    Each primitive books exactly the ``GatherStats`` that the real one
    books (the bytes received by kind, ``calls``; ``halo_calls`` and
    ``state_calls`` where the real call counts them; ``seconds`` stays 0)
    and appends a ``CollectiveRecord`` to the ``StepCounter`` running
    (``repro_torch.launch.hlo_analysis``), with the device bytes it reads
    and writes.  The autograd functions around the collectives and the
    ``Tape`` of a rematerialised region run on it unchanged, so a
    backward books its transposes as on the card.  A host staging buffer
    is a meta tensor made outside the counter's view (it is not card
    memory)."""

    def _book(self, prim: str, kind: str, operand: int, received: int,
              moved: int, calls: int = 1) -> None:
        """``GatherStats`` as the real primitive books them, and the
        counter's record of one ``prim`` call."""
        from repro_torch.launch.hlo_analysis import collective
        if calls:
            self._end(0.0, kind, received)
        counter = _counter()
        if counter is not None:
            counter.add_collective(collective(
                prim, operand, self.world_size, booked=kind,
                received_bytes=received, calls=calls, axis=self.axis), moved)

    def _begin(self, t: torch.Tensor) -> float:
        return 0.0

    def _end(self, t0: float, kind: str, received: int) -> None:
        field = f"{kind}_bytes"
        setattr(self.stats, field, getattr(self.stats, field) + received)
        self.stats.calls += 1

    @staticmethod
    def _host_copy(t: torch.Tensor, dtype=None) -> torch.Tensor:
        flat = t.detach().contiguous().reshape(-1)
        with _on_host():
            return torch.empty(flat.shape, dtype=dtype or flat.dtype,
                               device="meta")

    def _gather(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        P, n = self.world_size, _nbytes(t)
        self._to_host(t)
        out = torch.empty((P, *t.shape), dtype=t.dtype, device=t.device)
        self._book("all-gather", kind, n, n * (P - 1), n + P * n)
        return out

    def _gather_joined(self, pieces: List[torch.Tensor],
                       dims: List[Optional[int]]) -> List[torch.Tensor]:
        P = self.world_size
        outs: List[Optional[torch.Tensor]] = [None] * len(pieces)
        for bucket in _buckets([(t.dtype, t.shape) for t in pieces]):
            n = sum(_nbytes(pieces[i]) for i in bucket)
            for i in bucket:
                t = pieces[i]
                self._to_host(t)
                outs[i] = torch.empty(_joined_shape(t.shape, dims[i], P),
                                      dtype=t.dtype, device=t.device)
            self._book("all-gather", "param", n, n * (P - 1), n + P * n)
        return outs

    def reduce_scatter(self, t: torch.Tensor, kind: str = "grad"
                       ) -> torch.Tensor:
        P = self.world_size
        if t.shape[0] != P:
            raise ValueError(f"reduce_scatter: leading dim {t.shape[0]} is "
                             f"not the group's {P} ranks")
        host = self._host_copy(t, torch.float32)
        out = torch.empty(t.shape[1:], dtype=torch.float32, device=t.device)
        self._book("reduce-scatter", kind, host.numel() * 4,
                   out.numel() * 4 * (P - 1), _nbytes(t) + _nbytes(out))
        return out

    def _sum_bucket(self, flat: torch.Tensor, kind: str) -> torch.Tensor:
        out = torch.empty_like(flat)
        n = _nbytes(flat)
        self._book("all-reduce", kind, n, n * (self.world_size - 1), 2 * n)
        return out

    def _tp_sum(self, t: torch.Tensor) -> torch.Tensor:
        host = self._host_copy(t, torch.float32)
        out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
        n = host.numel() * 4
        self._book("all-reduce", "tp", n, n * (self.world_size - 1),
                   _nbytes(t) + _nbytes(out))
        return out

    def _post(self, host, like, kind, chunks, t0, dst: Optional[int],
              src: Optional[int], *, tag: Optional[int] = None,
              tracked: Optional[torch.Tensor] = None) -> "RingTransfer":
        n = chunks if chunks > 1 and host.numel() % chunks == 0 else 1
        if tag is None:
            self._take_tags(n)
        link = ((tracked, n, self._take_tags(n)) if _tracked(tracked)
                else None)
        return _AbstractTransfer(self, host, like, kind,
                                 0 if dst is None else host.numel(),
                                 0 if src is None else host.numel(), link)

    def pass_on(self, fn, like, device, anchor, *, kind: str = "state"):
        if self._replaying():
            return fn(self._replay())[0]
        tag = self._take_tags(2)
        self.stats.state_calls += 1
        grad = _tracked(anchor)
        nbytes = leaves_bytes(like)
        got = None
        if self.rank > 0:
            buf = torch.empty((nbytes,), dtype=torch.uint8, device=device)
            self._book("collective-permute", kind, 0, nbytes, nbytes)
            if grad:
                got = dict(zip(like, _ChainReceived.apply(
                    self, tag + 1, like, buf, anchor)))
            else:
                got = unpack_leaves(buf, like)
        out, to_send = fn(self._record(got))
        if self.rank < self.world_size - 1:
            final = [to_send[name] for name in like]
            self._to_host(pack_leaves(dict(zip(like, final))))
            self._book("collective-permute", kind, nbytes, 0, nbytes,
                       calls=0)
            if grad and _tracked(*final):
                out = _ChainSent.apply(self, tag + 1, out, *final)
        return out

    def _chain_send(self, flat: torch.Tensor, tag: int) -> None:
        self._host_copy(flat)
        self._book("collective-permute", "grad", _nbytes(flat), 0,
                   _nbytes(flat), calls=0)

    def _chain_recv(self, n: int, device, tag: int) -> torch.Tensor:
        out = torch.empty((n,), dtype=torch.float32, device=device)
        self._book("collective-permute", "grad", 0, n * 4, n * 4)
        return out

    def _broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        host = self._to_host(t)
        out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
        n = host.numel()
        self._book("broadcast", "output", n, 0 if self.rank == src else n,
                   2 * n)
        return out

    def _reduce_to(self, t: torch.Tensor, dst: int) -> Optional[torch.Tensor]:
        host = self._host_copy(t, torch.float32)
        mine = self.rank == dst
        n = host.numel() * 4
        self._book("reduce", "grad", n, n * (self.world_size - 1)
                   if mine else 0, _nbytes(t) + (n if mine else 0))
        return torch.empty(t.shape, dtype=torch.float32,
                           device=t.device) if mine else None

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        return obj

    def all_gather_object(self, obj: Any) -> List[Any]:
        return [obj] * self.world_size


class _AbstractTransfer(RingTransfer):
    """A point-to-point transfer of an ``AbstractSeqGroup``: its wait
    books what the real one books and gives a meta tensor."""

    def __init__(self, group, host, like, kind, sent: int, received: int,
                 link):
        super().__init__(group, [], host, host, like, kind,
                         received=received, link=link)
        self.sent_bytes = sent

    def wait(self) -> torch.Tensor:
        like = self.like
        out = torch.empty(like.shape, dtype=like.dtype, device=like.device)
        g = self.group
        g._book("collective-permute", self.kind, self.sent_bytes,
                self.received, self.sent_bytes + self.received)
        if self.link is not None:
            tracked, chunks, tag = self.link
            out = _RingLink.apply(g, tracked, out, chunks, tag)
        self.out = g._record(out) if self.record else out
        return out


_GROUPS: Dict[str, SeqGroup] = {}    # per process, like torch.distributed's
                                     # own default group


def init_seq_group(rank: int, world_size: int, store_path: str,
                   axis: str = "seq") -> SeqGroup:
    """Join the gloo group of ``world_size`` ranks that rendezvous at the
    file ``store_path`` and register it under ``axis``."""
    _init_world(rank, world_size, store_path)
    return register_seq_group(SeqGroup(axis, rank, world_size))


def _init_world(rank: int, world_size: int, store_path: str) -> None:
    if not dist.is_initialized():
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world_size)


def register_seq_group(group: SeqGroup) -> SeqGroup:
    """Register ``group`` under its axis name (one group an axis a
    process)."""
    if group.axis in _GROUPS:
        raise RuntimeError(f"seq group {group.axis!r} already initialised "
                           f"in this process")
    _GROUPS[group.axis] = group
    return group


def unregister_seq_group(axis: str) -> None:
    _GROUPS.pop(axis, None)


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


def _rank_entry(fn, rank, world_size, store_path, join, results, args):
    torch.set_num_threads(1)
    try:
        _init_world(rank, world_size, store_path)
        leave = join(rank, world_size)
        try:
            out = fn(rank, world_size, *args)
        finally:
            leave()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class _JoinAxis:
    """Register the whole world as the seq group of ``axis``."""

    def __init__(self, axis: str):
        self.axis = axis

    def __call__(self, rank: int, world_size: int):
        register_seq_group(SeqGroup(self.axis, rank, world_size))
        return lambda: unregister_seq_group(self.axis)


class _JoinMesh:
    """Join the mesh of ``shape`` over ``names`` (``launch.mesh``)."""

    def __init__(self, shape, names):
        self.shape, self.names = tuple(shape), tuple(names)

    def __call__(self, rank: int, world_size: int):
        from repro_torch.launch import mesh as mesh_mod
        mesh_mod.set_mesh(mesh_mod.make_auto_mesh(self.shape, self.names))
        return mesh_mod.leave_mesh


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
    return _run_ranks(fn, world_size, _JoinAxis(axis), args, timeout)


def spawn_mesh(fn: Callable, shape, names, *args, timeout: float = 120.0
               ) -> List[Any]:
    """As :func:`spawn`, over ``prod(shape)`` ranks that join the mesh of
    ``shape`` over the axis ``names`` (``launch.mesh.make_auto_mesh``, then
    ``set_mesh`` in every rank: one seq group a line of each axis, under
    the axis's name); ``fn(rank, world_size, *args)`` → the results in
    global rank order."""
    world = math.prod(shape)
    return _run_ranks(fn, world, _JoinMesh(shape, names), args, timeout)


def _run_ranks(fn, world_size, join, args, timeout) -> List[Any]:
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="seq_group_")
    store_path = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world_size, store_path, join, results,
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
                raise TimeoutError(f"{world_size} ranks did not "
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
