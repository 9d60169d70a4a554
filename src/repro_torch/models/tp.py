"""Tensor parallelism over the ``model`` axis of a ``("data", "model")``
mesh: which parts of a model a rank computes with its block of the
weights, and the context a mesh step runs its model in.

The JAX package shards a ``local`` plan's weights over ``model``
(``sharding.specs``: ``wq/wk/wv/w_up/w_gate`` by columns, ``wo/w_down`` by
rows, the vocabulary, the MoE experts) and GSPMD inserts the collectives.
The port writes them out (Megatron's layout, ``core.seq_group``'s
``copy_to`` / ``reduce_from`` / ``gather_from`` over the row):

* attention: a rank runs ``n_heads / M`` query heads and ``n_kv / M`` KV
  heads (``AttnSpec.tp``), where M divides both (not MLA, whose latent
  projections are gathered whole);
* an MLP (the dense layers', the moe family's first layers', the cross
  layers'): column then row, where M divides its width;
* the MoE experts: a rank runs its ``E / M`` experts over all the row's
  tokens, where M divides E (the router gathered whole; the shared
  expert whole too: the JAX plan takes it for an expert stack, ``"moe/"
  in path``, and shards its layers, never its width);
* the vocabulary: ``embed`` looks up the rank's rows of the table and
  ``unembed`` gives the rank's columns of the logits, where M divides V.

Under a decode plan that shards the sequence over ``model`` (``prism``,
``voltage``: ``make_plan(..., decode=True)``) the attention stays
replicated and its cache sequence-sharded, and only the MLPs and the
experts split over the row (``specs.py``'s ``use_tp``): every rank of the
row holds the step's one token.  A training or full-sequence plan that
shards the sequence over ``model`` splits nothing.

Every other leaf the JAX spec shards over ``model`` (norm scales, the
router, the qkv biases, MLA's, Mamba's and xLSTM's projections, the heads
of an attention M does not divide) is gathered whole over the row before
the step (``sharding.placement``) and computed on every rank of the row
alike.

A mesh step runs its model inside ``on_mesh(plan, group)`` (the row's seq
group; ``batch``: the column, where the batch is sharded over ``data``,
whose routing sums the moe aux loss takes); the model's functions read
the context (``heads``, ``ffn``, ``vocab``, ``batch_group``)
and off a mesh it is empty, so nothing changes.  A backward that
rematerialises layers (``models.remat``) must run inside the same block.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import NamedTuple, Optional

_QKV = ("wq", "wk", "wv")
_MLP = ("w_gate", "w_up", "w_down")          # an MLP's, or an expert stack's


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """What splits over a model axis of ``M`` ranks: the attention heads
    and the vocabulary as well (``full``, a ``local`` plan), or only the
    MLPs and the experts (a decode plan over the sequence)."""
    M: int
    full: bool

    def splits_heads(self, cfg) -> bool:
        return (self.full and cfg.mla is None and cfg.n_heads % self.M == 0
                and cfg.n_kv_heads % self.M == 0)

    def splits_width(self, width: int) -> bool:
        return width % self.M == 0

    def splits_vocab(self, V: int) -> bool:
        return self.full and V % self.M == 0

    def leaf_dim(self, key: str, shape, cfg) -> Optional[int]:
        """The dim of JAX-layout leaf ``key`` (``shape``) whose blocks a
        rank computes with, or None (gathered whole)."""
        parts = key.split("/")
        name, parent = parts[-1], parts[-2] if len(parts) > 1 else ""
        if key in ("embed/table", "lm_head/table"):
            return 0 if self.splits_vocab(shape[0]) else None
        if parent in ("attn", "xattn") and name in _QKV + ("wo",):
            if not self.splits_heads(cfg):
                return None
            return len(shape) - (2 if name == "wo" else 1)
        if parent == "mlp" and name in _MLP:
            width = shape[-2] if name == "w_down" else shape[-1]
            if not self.splits_width(width):
                return None
            return len(shape) - (2 if name == "w_down" else 1)
        if parent == "moe" and name in _MLP:
            stack = len(shape) - 3
            return stack if self.splits_width(shape[stack]) else None
        return None

    def sliced_dim(self, key: str, shape, cfg) -> Optional[int]:
        """The dim of a leaf gathered whole that a rank consumes a slice
        of (the qkv biases of split heads): its gradient is that slice's
        only, so the row sums it."""
        parts = key.split("/")
        if (len(parts) > 1 and parts[-2] == "attn"
                and parts[-1] in ("bq", "bk", "bv")
                and self.splits_heads(cfg)):
            return len(shape) - 1
        return None


def plan_of(plan, cfg) -> Optional[TPPlan]:
    """The TP of a ``ShardingPlan`` for ``cfg`` (None: nothing splits over
    ``model``): a ``local`` plan splits heads, MLPs, experts and the
    vocabulary; a decode plan over the sequence the MLPs and experts; a
    model axis of 1, the ViT and a training or forward plan over the
    sequence nothing."""
    M = plan.mesh.shape.get("model", 1)
    if M == 1 or cfg.family == "vit":
        return None
    if plan.seq_axis is None:
        return TPPlan(M, full=True)
    return TPPlan(M, full=False) if plan.decode else None


class Context(NamedTuple):
    plan: Optional[TPPlan] = None
    group: object = None           # the row's SeqGroup
    batch: object = None           # the column's SeqGroup (batch sharded)


_CTX = contextvars.ContextVar("mesh_context", default=Context())


@contextlib.contextmanager
def on_mesh(plan: Optional[TPPlan], group=None, batch=None):
    """Run the model inside: TP over ``group`` (the row) as ``plan`` says
    (None: none), and the moe aux loss's routing sums over ``batch`` (the
    column, where the batch is sharded over ``data``; None: not)."""
    if plan is not None and group.world_size != plan.M:
        raise ValueError(f"a TP plan of {plan.M} ranks on a row of "
                         f"{group.world_size}")
    token = _CTX.set(Context(plan, group if plan is not None else None,
                             batch))
    try:
        yield
    finally:
        _CTX.reset(token)


def group():
    """The row's group while anything splits over it, else None."""
    return _CTX.get().group


def heads(cfg):
    """The row's group if the attention heads split over it."""
    c = _CTX.get()
    return c.group if c.plan is not None and c.plan.splits_heads(cfg) \
        else None


def ffn(width: int):
    """The row's group if an MLP of ``width``, or a stack of ``width``
    experts, splits over it."""
    c = _CTX.get()
    return c.group if c.plan is not None and c.plan.splits_width(width) \
        else None


def vocab(V: int):
    """The row's group if the vocabulary splits over it."""
    c = _CTX.get()
    return c.group if c.plan is not None and c.plan.splits_vocab(V) \
        else None


def batch_group():
    """The column's group where the batch is sharded over ``data``."""
    return _CTX.get().batch
