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
  ``w_uk/w_uv`` and its rows of ``wo``; where M divides a latent's width
  it also runs its column block of ``w_dq`` or ``w_dkv`` and gathers the
  latent over the row (``gather_to``) before the norm, which is whole;
  a latent M does not divide is computed whole on every rank and enters
  the row's parallel region;
* an MLP (the dense layers', the moe family's first layers', the cross
  layers'): column then row, where M divides its width;
* the MoE experts: a rank runs its ``E / M`` experts over all the row's
  tokens, where M divides E (the router gathered whole; the shared
  expert whole too: the JAX plan takes it for an expert stack, ``"moe/"
  in path``, and shards its layers, never its width);
* the vocabulary: ``embed`` looks up the rank's rows of the table and
  ``unembed`` gives the rank's columns of the logits, where M divides V;
* the recurrent mixers, by channel (``Split``): Mamba (hymba) a block of
  its inner channels where M divides them (its rows of ``w_out`` summed
  over the row, ``xc`` gathered for ``dt``, the ``B``/``C`` product of its
  rows summed); the mLSTM a block of its value channels (``w_v``'s
  columns) where M divides them into whole heads or whole heads into
  them, its q, k, gates and normaliser whole on every rank; the sLSTM
  whole heads where M divides its heads, else whole on every rank (1 of
  every 8 xLSTM blocks at M 16: xlstm-350m's 4 heads), its FFN split
  where M divides its width ``int(4d / 3)`` (never at the configs'
  widths, 1365 and 85).

Where the rank's block is not the JAX spec's block of a leaf (the uneven
split, M not dividing the columns, a mixer's x and z halves or gates side
by side in one leaf, rows where the spec splits columns) the leaf is moved
between the two over the row (``sharding.placement``); a rank's block may
be several ranges of the leaf's dim (``leaf_block``).  A leaf held whole
whose gradient is the rank's part only (a shared KV head's ``wk/wv``, the
qkv biases of split heads, the mLSTM's ``w_q/w_k/w_if/b_if``, the norms
of a gathered MLA latent) is summed over the row (``sliced_dim``).

Under a decode plan that shards the sequence over ``model`` (``prism``,
``voltage``: ``make_plan(..., decode=True)``) the attention stays
replicated and its cache sequence-sharded, and only the MLPs and the
experts split over the row (``specs.py``'s ``use_tp``): every rank of the
row holds the step's one token.  A training or full-sequence plan that
shards the sequence over ``model`` splits nothing.

Every other leaf the JAX spec shards over ``model`` (norm scales, the
router, the heads of an attention no rule splits, a latent or mixer that
M does not divide, the sLSTM's FFN) is gathered whole over the row before
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

    def latent(self, cfg, width: int) -> bool:
        """Does an MLA latent of ``width`` columns split over the row (its
        heads split, and M divides it)?"""
        return self.heads(cfg, 0) is not None and width % self.M == 0

    def mamba(self, cfg, r: int) -> Optional[Tuple[int, int]]:
        """Rank ``r``'s block ``[lo, hi)`` of a Mamba mixer's inner
        channels, or None (whole)."""
        if not self.full or cfg.ssm is None or cfg.family != "hybrid":
            return None
        return _even(cfg.ssm.expand * cfg.d_model, self.M, r)

    def mlstm(self, cfg, r: int) -> Optional[Tuple[int, int]]:
        """Rank ``r``'s block ``[lo, hi)`` of an mLSTM's value channels
        (the columns of ``w_v``), or None (whole): whole heads a rank, or
        one head shared by ``M / H`` ranks."""
        if not self.full or cfg.family != "ssm":
            return None
        H = cfg.ssm.mlstm_heads
        dh = int(cfg.d_model * cfg.ssm.proj_factor) // H
        w, rest = divmod(H * dh, self.M)
        if rest or (w % dh and dh % w):
            return None
        return (r * w, (r + 1) * w)

    def slstm(self, cfg, r: int) -> Optional[Tuple[int, int]]:
        """Rank ``r``'s block ``[lo, hi)`` of an sLSTM's channels, whole
        heads (its recurrence mixes the channels of a head at every step),
        or None (whole: M does not divide the heads)."""
        if not self.full or cfg.family != "ssm" \
                or cfg.ssm.mlstm_heads % self.M \
                or cfg.d_model % cfg.ssm.mlstm_heads:
            return None
        return _even(cfg.d_model, self.M, r)

    def leaf_block(self, key: str, shape, cfg, r: int
                   ) -> Optional[Tuple[int, Tuple[Tuple[int, int], ...]]]:
        """(dim, ranges): the ``[start, stop)`` ranges of JAX-layout leaf
        ``key`` (``shape``) along ``dim``, in order, that rank ``r``
        computes with (joined, its block), or None (gathered whole)."""
        parts = key.split("/")
        name, parent = parts[-1], parts[-2] if len(parts) > 1 else ""

        def block(dim, *ranges):
            return (dim % len(shape), tuple(ranges))

        def even(dim):
            n = shape[dim]
            return block(dim, (r * n // self.M, (r + 1) * n // self.M))
        if key in ("embed/table", "lm_head/table"):
            return even(0) if self.splits_vocab(shape[0]) else None
        if parent in ("attn", "xattn"):
            h = self.heads(cfg, r)
            if h is None:
                return None
            lo, n = h.q0, h.n_q
            if cfg.mla is not None and parent == "attn":   # (dim, a head's)
                m = cfg.mla
                if name in ("w_dq", "w_dkv"):
                    return even(-1) if self.latent(cfg, shape[-1]) else None
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
            return block(dim, (lo * w, (lo + n) * w))
        if parent == "mlp" and name in _MLP:
            dim = -2 if name == "w_down" else -1
            return even(dim) if self.splits_width(shape[dim]) else None
        if parent == "moe" and name in _MLP:
            stack = len(shape) - 3
            return even(stack) if self.splits_width(shape[stack]) else None
        if parent in ("mamba", "mlstm", "slstm"):
            return self._mixer_block(parent, name, shape, cfg, r, block)
        return None

    def _mixer_block(self, parent: str, name: str, shape, cfg, r: int,
                     block):
        """``leaf_block`` of a recurrent mixer's leaf: its rows, columns
        or entries of the rank's channels (both halves of ``w_in``, the z
        half of the mLSTM's ``w_up``, each of the sLSTM's four gates)."""
        ch = getattr(self, parent)(cfg, r)
        if ch is None:
            return None
        lo, hi = ch
        if name == "w_in" or (parent == "mlstm" and name == "w_up"):
            di = shape[-1] // 2         # x ‖ z: the mLSTM's x half whole
            x = (lo, hi) if parent == "mamba" else (0, di)
            return block(-1, x, (di + lo, di + hi))
        if parent in ("mamba", "mlstm"):
            dim = {"conv": -1, "w_dt": -1, "dt_bias": -1, "d_skip": -1,
                   "w_v": -1, "gn_scale": -1, "w_bc": -2, "a_log": -2,
                   "w_out": -2, "w_down": -2}.get(name)
            return None if dim is None else block(dim, (lo, hi))
        d = cfg.d_model
        if name in ("w_x", "b"):                  # the (i, f, z, o) gates
            return block(-1, *((g * d + lo, g * d + hi) for g in range(4)))
        if name == "r":                           # [4, H, dh, dh]: heads
            dh = d // cfg.ssm.mlstm_heads
            return block(-3, (lo // dh, hi // dh))
        if name == "gn_scale":
            return block(-1, (lo, hi))
        du = int(d * 4 / 3)                       # the FFN, where M divides
        u = _even(du, self.M, r)
        if u is None or name not in ("w_up", "w_down"):
            return None
        if name == "w_down":
            return block(-2, u)
        return block(-1, u, (du + u[0], du + u[1]))

    def sliced_dim(self, key: str, shape, cfg, r: int) -> Optional[int]:
        """The dim of a leaf gathered whole whose gradient is the rank's
        part only, so the row sums it: one the rank consumes a slice of
        (the qkv biases of split heads, a shared KV head's ``wk/wv``), or
        one used whole by a computation split over the row behind it (the
        mLSTM's ``w_q``, ``w_k``, ``w_if``, ``b_if``; the norm of an MLA
        latent gathered over the row)."""
        parts = key.split("/")
        if len(parts) < 2:
            return None
        name, parent = parts[-1], parts[-2]
        if parent == "mlstm" and name in ("w_q", "w_k", "w_if", "b_if"):
            return len(shape) - 1 if self.mlstm(cfg, r) is not None \
                else None
        if len(parts) > 2 and parts[-3] == "attn" and cfg.mla is not None \
                and parent in ("q_norm", "kv_norm"):
            m = cfg.mla
            width = m.q_lora_rank if parent == "q_norm" else \
                m.kv_lora_rank + m.qk_rope_dim
            return len(shape) - 1 if self.latent(cfg, width) else None
        if parent not in ("attn", "xattn") or cfg.mla is not None:
            return None
        h = self.heads(cfg, r)
        if h is None:
            return None
        if name in ("bq", "bk", "bv") or (h.shared and name in ("wk", "wv")):
            return len(shape) - 1
        return None


def _even(n: int, M: int, r: int) -> Optional[Tuple[int, int]]:
    """Rank ``r``'s block of ``n`` split evenly over ``M``, or None."""
    return None if n % M else (r * n // M, (r + 1) * n // M)


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


class Split(NamedTuple):
    """A recurrent mixer split over the row: the row's group and the
    rank's block ``[lo, hi)`` of its channels (``TPPlan.mamba``,
    ``mlstm``, ``slstm``)."""
    group: object
    lo: int
    hi: int


def mixer(cfg, kind: str) -> Optional[Split]:
    """The row's split of a ``kind`` (``"mamba"``, ``"mlstm"`` or
    ``"slstm"``) mixer of ``cfg``, or None (whole on every rank)."""
    c = _CTX.get()
    ch = None if c.plan is None else getattr(c.plan, kind)(cfg, c.group.rank)
    return None if ch is None else Split(c.group, *ch)


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
