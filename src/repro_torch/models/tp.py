"""Tensor parallelism over the ``model`` axis of a ``("data", "model")``
mesh: which parts of a model a rank computes with its block of the
weights, and the context a mesh step runs its model in.

The JAX package shards a ``local`` plan's weights over ``model``
(``sharding.specs``: ``wq/wk/wv/w_up/w_gate`` by columns, ``wo/w_down`` by
rows, MLA's ``w_uq`` by columns and ``w_uk/w_uv`` by heads, the
vocabulary, the MoE experts) and GSPMD inserts the collectives.  The port
writes them out (Megatron's layout, ``core.seq_group``'s ``copy_to`` /
``reduce_from`` / ``gather_from`` over the row):

* attention: a rank runs a range of query heads and the KV heads they
  read (``head_split``, ``AttnSpec.tp``): M's equal shares where M divides
  the KV heads; whole KV groups, as even as they go, where M does not but
  there are at least M of them (hymba's 25/5 on 2 ranks: 15 + 10 heads);
  ``n_heads / M`` query heads of one KV head shared by ``M / n_kv`` ranks
  where the KV heads are fewer than M (the vision model's 32/8 on 16);
* MLA: a rank runs its heads' columns of ``w_uq``, its heads of
  ``w_uk/w_uv`` and its rows of ``wo``; the latent projections
  (``w_dq``, ``w_dkv``, the norms) are whole on every rank of the row,
  and the latent enters the row's parallel region;
* an MLP (the dense layers', the moe family's first layers', the cross
  layers'): column then row, where M divides its width;
* the MoE experts: a rank runs its ``E / M`` experts over all the row's
  tokens, where M divides E (the router gathered whole; the shared
  expert whole too: the JAX plan takes it for an expert stack, ``"moe/"
  in path``, and shards its layers, never its width);
* the vocabulary: ``embed`` looks up the rank's rows of the table and
  ``unembed`` gives the rank's columns of the logits, where M divides V.

Where the rank's head block is not the JAX spec's block of a leaf (the
uneven split, or M not dividing the columns) the leaf is moved between
the two over the row (``sharding.placement``).  A shared KV head's
``wk/wv`` are held whole and sliced, as the qkv biases are.

Under a decode plan that shards the sequence over ``model`` (``prism``,
``voltage``: ``make_plan(..., decode=True)``) the attention stays
replicated and its cache sequence-sharded, and only the MLPs and the
experts split over the row (``specs.py``'s ``use_tp``): every rank of the
row holds the step's one token.  A training or full-sequence plan that
shards the sequence over ``model`` splits nothing.

Every other leaf the JAX spec shards over ``model`` (norm scales, the
router, MLA's latent projections, Mamba's and xLSTM's projections, the
heads of an attention no rule splits) is gathered whole over the row
before the step (``sharding.placement``) and computed on every rank of
the row alike.

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
from typing import NamedTuple, Optional, Tuple

_MLP = ("w_gate", "w_up", "w_down")          # an MLP's, or an expert stack's


class Heads(NamedTuple):
    """A rank's attention heads: query heads ``[q0, q0 + n_q)`` and the KV
    heads they read, ``[kv0, kv0 + n_kv)``; ``shared``: the one KV head is
    other ranks' too (its ``wk/wv`` held whole, each rank its slice)."""
    q0: int
    n_q: int
    kv0: int
    n_kv: int
    shared: bool = False


def head_split(n_heads: int, n_kv: int, M: int, r: int) -> Optional[Heads]:
    """Rank ``r`` of ``M``'s heads of an attention of ``n_heads`` query
    and ``n_kv`` KV heads, or None (the heads do not split):

    (i) M divides ``n_kv``: equal blocks of whole KV groups;
    (ii) ``n_kv ≥ M``: whole KV groups as even as they go, the larger
         blocks first (a rank's query heads per KV head stay the config's);
    (iii) ``n_kv < M``, M a multiple of ``n_kv`` whose share ``s = M /
         n_kv`` divides the group: ``n_heads / M`` query heads of KV head
         ``r // s``."""
    if n_kv <= 0 or n_heads % n_kv:
        return None
    G = n_heads // n_kv
    if n_kv >= M:
        base, extra = divmod(n_kv, M)
        kv0, k = r * base + min(r, extra), base + (r < extra)
        return Heads(kv0 * G, k * G, kv0, k)
    s = M // n_kv
    if M % n_kv == 0 and G % s == 0:
        return Heads(r * (G // s), G // s, r // s, 1, shared=True)
    return None


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """What splits over a model axis of ``M`` ranks: the attention heads
    and the vocabulary as well (``full``, a ``local`` plan), or only the
    MLPs and the experts (a decode plan over the sequence)."""
    M: int
    full: bool

    def heads(self, cfg, r: int) -> Optional[Heads]:
        """Rank ``r``'s attention heads, or None (not split)."""
        if not self.full:
            return None
        return head_split(cfg.n_heads, cfg.n_kv_heads, self.M, r)

    def splits_width(self, width: int) -> bool:
        return width % self.M == 0

    def splits_vocab(self, V: int) -> bool:
        return self.full and V % self.M == 0

    def leaf_block(self, key: str, shape, cfg, r: int
                   ) -> Optional[Tuple[int, int, int]]:
        """(dim, start, stop): the block of JAX-layout leaf ``key``
        (``shape``) along ``dim`` that rank ``r`` computes with, or None
        (gathered whole)."""
        parts = key.split("/")
        name, parent = parts[-1], parts[-2] if len(parts) > 1 else ""

        def even(dim):
            n = shape[dim]
            return (dim % len(shape), r * n // self.M, (r + 1) * n // self.M)
        if key in ("embed/table", "lm_head/table"):
            return even(0) if self.splits_vocab(shape[0]) else None
        if parent in ("attn", "xattn"):
            h = self.heads(cfg, r)
            if h is None:
                return None
            lo, n = h.q0, h.n_q
            if cfg.mla is not None and parent == "attn":   # (dim, a head's)
                m = cfg.mla
                width = {"w_uq": (-1, m.qk_nope_dim + m.qk_rope_dim),
                         "w_uk": (-2, 1), "w_uv": (-2, 1),
                         "wo": (-2, m.v_head_dim)}.get(name)
            elif name in ("wk", "wv"):        # a shared KV head: sliced
                width = None if h.shared else (-1, cfg.hd)
                lo, n = h.kv0, h.n_kv
            else:
                width = {"wq": (-1, cfg.hd), "wo": (-2, cfg.hd)}.get(name)
            if width is None:
                return None
            dim, w = width
            return (dim % len(shape), lo * w, (lo + n) * w)
        if parent == "mlp" and name in _MLP:
            dim = -2 if name == "w_down" else -1
            return even(dim) if self.splits_width(shape[dim]) else None
        if parent == "moe" and name in _MLP:
            stack = len(shape) - 3
            return even(stack) if self.splits_width(shape[stack]) else None
        return None

    def sliced_dim(self, key: str, shape, cfg, r: int) -> Optional[int]:
        """The dim of a leaf gathered whole that a rank consumes a slice
        of (the qkv biases of split heads, a shared KV head's
        ``wk/wv``): its gradient is that slice's only, so the row sums
        it."""
        parts = key.split("/")
        if len(parts) < 2 or parts[-2] not in ("attn", "xattn") \
                or cfg.mla is not None:
            return None
        h = self.heads(cfg, r)
        if h is None:
            return None
        if parts[-1] in ("bq", "bk", "bv") or (
                h.shared and parts[-1] in ("wk", "wv")):
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
    """(the row's group, this rank's ``Heads``) if the attention heads
    split over the row, else (None, None)."""
    c = _CTX.get()
    h = None if c.plan is None else c.plan.heads(cfg, c.group.rank)
    return (None, None) if h is None else (c.group, h)


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
