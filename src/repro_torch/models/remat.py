"""Per-layer rematerialisation in training: the port's counterpart of the
JAX package's ``jax.checkpoint`` around every layer of its layer scans
(``repro.models.transformer``, its encoder, ``repro.models.vit``) and
around every chunk of its recurrent time scans
(``repro.models.ssm.chunked_time_scan``).

Where autograd follows a layer (grad enabled and a tensor of it requires
grad), ``region`` runs it under ``torch.utils.checkpoint``
(non-reentrant): the forward keeps the layer's inputs and drops its
activations, and the backward runs the layer again to get them back.  A
block of recurrent time steps goes the same way, so a scan keeps its
state only at block boundaries.  Serving, decode and profiling run
without grad and take the plain call.  (torch imports ``torch._dynamo``
at a process's first checkpoint: a few seconds, once.)

A layer of a partitioned plan calls staged collectives (the exchange's
gather, packed gather, ring and halo ``shift``, the recurrent ``pass_on``,
the moe routing call).  Its recompute must send nothing: a second
message would take fresh tags and meet the cotangents the backward is
exchanging.  So ``region`` hands the seq group a ``Tape``: the forward
records each collective's output on it (what crossed the wire, kept until
the backward), and the recompute takes the outputs from it in the same
order.  Every message is sent once, every tag is taken in the forward, and
the bytes booked by kind are those of a step without rematerialisation.

A layer's parameters are another matter.  On a mesh that shards them
over the batch axes (ZeRO-3, ``sharding.placement``) a layer runs on its
weights gathered from the ranks' blocks (``gathered``, inside ``layer``'s
region): that gather is never taped (``SeqGroup.gather_blocks``), so the
checkpoint keeps the rank's blocks and not the gathered layer, and the
recompute gathers the layer again, as the reference's rematerialised
scan of a sharded layer stack does.  Every rank of the batch axes runs the
same graph, so their forward gathers, recomputes' gathers and backward
reduce-scatters meet in the same order.

It is on by default, as in the reference, which has no off.  ``disabled``
turns it off inside a ``with`` block (the tests compare gradients with
and without it, bit for bit).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, Optional, Sequence, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.seq_group import SeqGroup, Tape
from repro_torch.utils.tree import tree_leaves

_ON = contextvars.ContextVar("remat", default=True)
_GATHER = contextvars.ContextVar("gather", default=None)


@contextlib.contextmanager
def disabled():
    """No rematerialisation inside the block: every activation is kept."""
    token = _ON.set(False)
    try:
        yield
    finally:
        _ON.reset(token)


@contextlib.contextmanager
def gathering(fn: Callable[[Any], Any]):
    """Inside the block, ``gathered(tree)`` is ``fn(tree)``: a mesh step's
    way from a layer's blocks to the weights it runs on
    (``sharding.placement.LayerView``)."""
    token = _GATHER.set(fn)
    try:
        yield
    finally:
        _GATHER.reset(token)


def gathered(tree: Any) -> Any:
    """``tree`` (a layer's params, or a top-level leaf's) as the model runs
    it: gathered from the rank's blocks inside ``gathering``, else itself.
    The model calls it where it reads the weights: at the top of a layer
    (``layer``), and at the embedding, the final norm and the head."""
    fn = _GATHER.get()
    return tree if fn is None else fn(tree)


def _gathered_call(fn: Callable, lp: Any, *args) -> Any:
    return fn(gathered(lp), *args)


def layer(fn: Callable, lp: Any, *args,
          group: Union[None, SeqGroup, Sequence[SeqGroup]] = None) -> Any:
    """``region(fn, lp, *args)`` with the layer's params ``lp`` gathered
    inside the region (``gathered``): the checkpoint keeps what ``lp``
    holds (the rank's blocks on a ZeRO-3 mesh), the recompute gathers
    again, and the gathered weights live only while the layer runs."""
    return region(_gathered_call, fn, lp, *args, group=group)


def active(*trees: Any) -> bool:
    """Would ``region`` rematerialise a region that reads ``trees``
    (tensors, or trees of them such as a layer's params)?"""
    return _ON.get() and torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for tree in trees for t in tree_leaves(tree))


def region(fn: Callable, *args,
           group: Union[None, SeqGroup, Sequence[SeqGroup]] = None) -> Any:
    """``fn(*args)``, rematerialised where ``active(args)``: a layer, or a
    block of a recurrent scan's time steps (the scan decides which blocks
    qualify: ``chunked``).  ``fn`` reads its tensors from ``args`` (a
    closure over a loop variable would be read again at recompute time);
    ``group`` is the seq group whose collectives ``fn`` may call, or a
    list of such groups (a mesh row and column; None or empty: none),
    each taped apart.  The recompute runs in the context variables of the
    forward (``models.tp``'s mesh context, this module's switch): a CUDA
    backward runs on autograd's own thread, which does not see them."""
    if not active(args):
        return fn(*args)
    groups = ([] if group is None else
              [group] if isinstance(group, SeqGroup) else list(group))
    tapes = [Tape() for _ in groups]
    ctx = contextvars.copy_context()

    def taped(*a):
        with contextlib.ExitStack() as stack:
            for g, tape in zip(groups, tapes):
                stack.enter_context(g.taping(tape))
            return fn(*a)

    return checkpoint(lambda *a: ctx.run(taped, *a), *args,
                      use_reentrant=False)


def chunked(T: int, chunk_len: int) -> bool:
    """Does a scan of ``T`` steps keep its state only at block boundaries
    (``repro.models.ssm.chunked_time_scan``'s rule: not when ``chunk_len
    <= 1``, ``T % chunk_len`` or ``T <= chunk_len``)?"""
    return not (chunk_len <= 1 or T % chunk_len or T <= chunk_len)
