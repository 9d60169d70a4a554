"""The loss, the train step and the eval step.

Port of ``repro.train.train_step``: next-token cross-entropy in f32 with a
z-loss and the model's aux loss, gradients by autograd, gradient
accumulation over microbatches into an f32 accumulator, and the AdamW
update.  The one-hot contraction becomes an index of the gold logit,
which gives the same value.  ``_pin_vocab`` keeps the JAX package's
logits vocab-sharded under tensor parallelism; the port does the same by
hand: under a vocab-parallel head (``tp.vocab``, a ``local`` plan's row)
``forward_lm`` hands the loss the rank's V/M columns, and the loss
combines the row's log-sum-exps and gold logits (one ``tp`` gather of two
numbers a token, ``_vocab_parallel``): no rank holds the whole
vocabulary's logits.

Under a partitioned plan (``voltage``/``prism`` across the ranks of a seq
group) every rank holds a full replica of the params and the same global
batch, runs its part of the sequence, and takes the loss of its own
tokens only: its logits never cross ranks (``forward_lm(...,
local_logits=True)``).  Each rank's loss is its tokens' sum divided by the
global B·N (and the aux loss, the same on every rank, divided by P), so
the ranks' losses sum to the reference's loss and their gradients sum to
its gradient.  The exchanges' gathers carry the gradient back across the
ranks (``SeqGroup.all_gather``'s backward), and one staged ``all_reduce``
sums the parameter gradients in f32, the same bits on every rank, so the
replicas stay identical.  The metrics are the global ones on every rank.

On a ``("data", "model")`` mesh (``build_train_step(..., placement=)``,
the JAX launcher's layout) each row of the mesh is such a seq group over
``model`` and takes its rows of the global batch (``data``); the params
are ZeRO-3 blocks over ``data`` and the optimizer state ZeRO-1 blocks over
both axes, leaf by leaf as the JAX plan says
(``repro_torch.sharding.placement``).  The loss divides by the global
B·N, and the gradients are summed over the whole mesh in f32.  The model
runs on a ``Placement.layer_view`` of the blocks: each layer is gathered
as the model reaches it, inside its rematerialised region (and again in
its recompute), and its gradient is reduce-scattered over ``data`` as the
backward leaves it; with ``grad_accum`` > 1 each microbatch's reduced
blocks are accumulated in ``acc_dtype``, as the JAX step's accumulator
pinned to the ZeRO-1 specs.  Under a
``local`` plan with a model axis over 1 the row is tensor-parallel
(``repro_torch.models.tp``): its ranks run the same rows with their
blocks of the split weights and hold the same loss, so the row sums no
loss and only the gradients of the leaves a rank consumed a slice of.
The moe family's aux loss is the whole batch's on every mesh: where the
batch is sharded over ``data``, the routing sums are summed over the
column inside the model.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.exchange import (ExchangeConfig, partitioned,
                                       seq_group_for)
from repro_torch.models import remat
from repro_torch.models import tp as tpm
from repro_torch.models import transformer as tfm
from repro_torch.train.optimizer import OptConfig, adamw_update, decay_mask
from repro_torch.utils.tree import tree_leaves, tree_unflatten_like


def _group(xcfg: ExchangeConfig):
    return seq_group_for(xcfg) if partitioned(xcfg) else None


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            xcfg: ExchangeConfig, batch_shards: int = 1):
    """Next-token cross-entropy (causal LMs) in f32 with z-loss → (loss,
    {"nll", "aux"}).  Under a partitioned plan: this rank's share (see the
    module's note).  ``batch_shards``: how many ``data`` ranks hold a part
    of the global batch, ``batch`` being this rank's (the global B·N is
    the local B·N times it)."""
    if cfg.family == "vit":
        raise ValueError("loss_fn is the causal LMs' next-token loss; a ViT "
                         "has no labels per token")
    group = _group(xcfg)
    logits, aux = tfm.forward_lm(params, batch, cfg, xcfg,
                                 local_logits=True)
    labels = batch["labels"]
    B, N = labels.shape
    if group is not None:
        n = logits.shape[1]
        labels = labels[:, group.rank * n:(group.rank + 1) * n]
        aux = aux / group.world_size
    aux = aux / batch_shards
    tp = tpm.vocab(cfg.vocab_size)
    if tp is not None:
        logz, gold = _vocab_parallel(tp, logits, labels)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    tokens = B * N * batch_shards
    nll = (logz - gold).sum() / tokens
    zloss = 1e-4 * torch.square(logz).sum() / tokens
    return nll + zloss + aux, {"nll": nll, "aux": aux}


def _vocab_parallel(tp, logits: torch.Tensor, labels: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log-sum-exp, gold logit) [B, N] of the whole vocabulary from this
    rank's ``[B, N, V/M]`` f32 columns: each rank's log-sum-exp of its
    columns and its gold logit (the label's column where the rank holds
    it, else 0) go over the row in one ``gather_from``, whose backward
    keeps the rank's own pair; the log-sum-exp of the row's log-sum-exps
    and the sum of its gold logits are the whole vocabulary's."""
    n = logits.shape[-1]
    local = labels.long() - tp.rank * n
    mine = (local >= 0) & (local < n)
    gold = logits.gather(-1, torch.where(mine, local, 0)[..., None])[..., 0]
    pair = torch.stack([torch.logsumexp(logits, dim=-1),
                        torch.where(mine, gold, torch.zeros_like(gold))], -1)
    row = tp.gather_from(pair)                       # [B, N, 2M]
    return torch.logsumexp(row[..., 0::2], dim=-1), row[..., 1::2].sum(-1)


def _grads_of(params, batch, cfg, xcfg, batch_shards: int = 1
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                         List[torch.Tensor]]:
    """(loss, parts, the gradient of every leaf in ``tree_leaves`` order,
    in the leaf's dtype; zeros for a leaf the loss does not reach).  A
    leaf that already requires grad (a ``LayerView``'s) is differentiated
    as it is; the others through grad-requiring aliases."""
    leaves = tree_leaves(params)
    live = [p if p.requires_grad else
            p.detach().requires_grad_(p.is_floating_point()) for p in leaves]
    loss, parts = loss_fn(tree_unflatten_like(params, live), batch, cfg,
                          xcfg, batch_shards)
    wrt = [t for t in live if t.requires_grad]
    got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = [next(got) if t.requires_grad else None for t in live]
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


def _split(batch: Dict[str, torch.Tensor], n: int) -> List[Dict]:
    """``n`` microbatches of equal size along the batch axis, in order."""
    chunks = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])
              for k, v in batch.items()}
    return [{k: v[i] for k, v in chunks.items()} for i in range(n)]


def _accumulated(params, batch, cfg, xcfg, grad_accum: int,
                 batch_shards: int = 1, acc_dtype=torch.float32):
    """(loss, parts, gradients) of ``batch``, in ``grad_accum``
    microbatches run one after another with an ``acc_dtype`` accumulator
    (the gradients come back in it)."""
    if grad_accum == 1:
        return _grads_of(params, batch, cfg, xcfg, batch_shards)
    acc = None
    losses, partss = [], []
    for mb in _split(batch, grad_accum):
        l, pa, g = _grads_of(params, mb, cfg, xcfg, batch_shards)
        acc = ([gi.to(acc_dtype) for gi in g] if acc is None else
               [a + gi.to(acc_dtype) for a, gi in zip(acc, g)])
        losses.append(l)
        partss.append(pa)
    grads = [a / grad_accum for a in acc]
    loss = torch.stack(losses).mean()
    parts = {k: torch.stack([p[k] for p in partss]).mean()
             for k in partss[0]}
    return loss, parts, grads


def _summed(group, loss, parts):
    """(loss, parts) summed over ``group``'s ranks (one ``meta`` call)."""
    keys = list(parts)
    tot = group.all_reduce(
        [torch.stack([loss] + [parts[k] for k in keys]).float()],
        kind="meta")[0]
    return tot[0], {k: tot[i + 1] for i, k in enumerate(keys)}


def build_train_step(cfg: ModelConfig, xcfg: ExchangeConfig,
                     opt_cfg: Optional[OptConfig] = None,
                     grad_accum: int = 1, placement=None,
                     acc_dtype=torch.float32) -> Callable:
    """(params, opt_state, batch) → (params, opt_state, metrics).

    ``grad_accum`` > 1 splits the global batch into microbatches run one
    after another with a gradient accumulator in ``acc_dtype`` (f32; the
    JAX dry run takes bf16 for archs over 100 GB of params): live
    activations shrink by the accumulation factor while keeping the global
    batch size.  Weight decay follows the JAX package's layout
    (``optimizer.decay_mask``).

    With a ``placement`` (``repro_torch.sharding.placement``: this rank's
    part of a mesh under a ``ShardingPlan``) the step is the mesh's:
    ``params`` are this rank's param-spec blocks and ``opt_state`` holds its
    optimizer-spec blocks, both keyed in the JAX layout
    (``mesh_gradients``), ``batch`` is the global batch on every rank, and
    the new params come back as blocks."""
    opt_cfg = opt_cfg or OptConfig()
    if placement is not None:
        return _mesh_step(cfg, placement, opt_cfg, grad_accum, acc_dtype)

    def train_step(params, opt_state, batch):
        group = _group(xcfg)
        loss, parts, grads = _accumulated(params, batch, cfg, xcfg,
                                          grad_accum, acc_dtype=acc_dtype)
        if group is not None:        # every rank: the global sums
            grads = group.all_reduce(grads, kind="grad")
            loss, parts = _summed(group, loss, parts)
        new_params, new_state, om = adamw_update(
            tree_unflatten_like(params, grads), opt_state, params, opt_cfg,
            decay_mask(params, cfg))
        return new_params, new_state, {"loss": loss, **parts, **om}

    return train_step


def mesh_gradients(blocks, batch, cfg: ModelConfig, placement,
                   grad_accum: int = 1, acc_dtype=torch.float32):
    """One rank's part of a mesh train step up to the update → (loss,
    parts, the f32 gradient's sum over the mesh of each of this rank's
    optimizer-spec blocks).

    The model runs on a ``LayerView`` of the param blocks: each layer
    gathered as the model reaches it (ZeRO-3, ``param`` bytes), never the
    whole tree; the rank runs its rows of the global ``batch`` (the plan's
    ``batch_shardings``: over ``data``, or ``("pod", "data")`` on a
    three-axis mesh; every rank of a row the same rows, the row's ranks
    each their part of the sequence); each layer's gradient is
    reduce-scattered over the batch axes as the backward leaves it, where
    the batch is sharded there, then summed over the row and what else is
    left (``Placement.reduce_gradients``); the loss likewise (``meta``;
    under TP the row's ranks hold the same loss, summed over the batch
    axes only).  A batch whose rows do not divide over the batch axes runs
    whole on every rank of the column, and its gradients are not summed
    there.  The model and its backward run inside
    ``placement.tp_context``."""
    from repro_torch.sharding.specs import axis_size
    xcfg = placement.plan.xcfg
    entry = placement.batch_entry(batch)
    shards = axis_size(placement.mesh, entry)
    view = placement.layer_view(blocks, grad=True, batch_entry=entry)
    with placement.tp_context(entry), remat.gathering(view):
        loss, parts, grads = _accumulated(
            view.tree, placement.batch_part(batch), cfg, xcfg, grad_accum,
            shards, acc_dtype)
    g = placement.reduce_gradients(view.block_grads(grads), entry)
    del grads
    row = placement._group("model")
    if row.world_size > 1 and placement.tp is None:
        loss, parts = _summed(row, loss, parts)
    if entry is not None:
        loss, parts = _summed(placement._group(entry), loss, parts)
    return loss, parts, g


def mesh_update(blocks, opt_state, grads, placement, opt_cfg: OptConfig):
    """AdamW on this rank's optimizer blocks from the summed ``grads``
    (``mesh_gradients``; clipped by the norm of the whole gradient, summed
    over the mesh) → (the new param-spec blocks, gathered back from the
    updated optimizer blocks, booked as ``param``; the new state; the
    optimizer's metrics)."""
    new, new_state, om = adamw_update(
        grads, opt_state, placement.opt_part(blocks), opt_cfg,
        placement.decay(), gnorm=placement.global_norm(grads))
    return placement.assemble(new), new_state, om


def _mesh_step(cfg, placement, opt_cfg: OptConfig,
               grad_accum: int, acc_dtype) -> Callable:
    def train_step(blocks, opt_state, batch):
        loss, parts, grads = mesh_gradients(blocks, batch, cfg, placement,
                                            grad_accum, acc_dtype)
        new, new_state, om = mesh_update(blocks, opt_state, grads,
                                         placement, opt_cfg)
        return new, new_state, {"loss": loss, **parts, **om}

    return train_step


def build_eval_step(cfg: ModelConfig, xcfg: ExchangeConfig) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            loss, parts = loss_fn(params, batch, cfg, xcfg)
            group = _group(xcfg)
            if group is not None:
                loss, parts = _summed(group, loss, parts)
        return {"loss": loss, **parts}
    return eval_step
