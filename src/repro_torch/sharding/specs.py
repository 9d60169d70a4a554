"""Sharding plans: param / optimizer-state / batch / cache partition specs
per execution mode.  Port of ``repro.sharding.specs``, rule for rule.

Mesh axes: ``("data", "model")`` single-pod (16×16) or
``("pod", "data", "model")`` multi-pod (2×16×16), a
``repro_torch.launch.mesh.Mesh`` of gloo ranks.

Execution modes map the paper's deployment choices onto the mesh:

* **LOCAL**: batch shards over (pod, data); the model axis does tensor
  parallelism — attention head-sharded where head counts divide, FFN
  column/row sharded, vocab sharded.  No sequence partitioning.  (The
  port runs the split layers by hand: ``repro_torch.models.tp``.)
* **VOLTAGE / PRISM**: the *sequence* shards over the model axis — the
  paper's position-wise partitions — and attention communicates over the
  row's seq group.  Weights shard over the batch axes only.

FSDP: architectures whose parameters exceed ``FSDP_THRESHOLD_GB``, and
every training plan, are sharded over the batch axes (ZeRO-3); optimizer
state is always sharded over the batch axes where divisible (ZeRO-1), and
its other logical dim over ``model``.

A spec is a ``PartitionSpec``: a tuple with one entry a dim, each an axis
name, a tuple of axis names, or None — the entries of JAX's
``PartitionSpec``.  The rules read the JAX package's layout, in which a
layer stack is one leaf with the layers on its leading (*stack*) dims
(``lax.scan``'s); the port keeps each stack as a list of per-layer trees
(``repro_torch.models.bridge``), so ``param_shardings`` and
``opt_state_shardings`` take the port's tree, key its leaves as the JAX
package's (``jax_layout_shapes``) and return a spec per JAX-layout key.  A
spec entry on a stack dim is a split of the layer list: which layers a
rank owns (``repro_torch.sharding.placement``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.exchange import ExchangeConfig, ExchangeMode
from repro_torch.launch.mesh import Mesh

FSDP_THRESHOLD_GB = 4.0

# [in, out] column-parallel mats (output dim is the TP dim in LOCAL mode)
_COL = {"wq", "wk", "wv", "w_up", "w_gate", "w_uq", "patch_embed", "head",
        "w_in", "w_x", "w_bc", "w_dt", "w_if", "w_q", "w_k", "w_v"}
_ROW = {"wo", "w_down", "w_out"}
_ATTN = {"wq", "wk", "wv", "wo"}          # replicated over model when the
                                          # sequence occupies the model axis
_EMBED = {"table"}


class PartitionSpec(tuple):
    """One entry a dim: an axis name, a tuple of names, or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    mesh: Mesh
    spec: PartitionSpec


class Shape(NamedTuple):
    """A leaf's shape, where a rule needs no more of it."""
    shape: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    mesh: Mesh
    mode: ExchangeMode
    batch_axes: Tuple[str, ...]          # axes sharding the batch dim
    tp_axis: str                          # "model"
    seq_axis: Optional[str]               # "model" in distributed modes
    fsdp: bool                            # ZeRO-3 params over batch axes
    L: int = 0                            # PRISM segment means per partition
    decode: bool = False                  # one-token steps: no seq/TP conflict
    train: bool = False

    @property
    def xcfg(self) -> ExchangeConfig:
        n = self.mesh.shape[self.seq_axis] if self.seq_axis else 1
        return ExchangeConfig(self.mode, self.seq_axis, n, L=self.L,
                              batch_axes=tuple(self.batch_axes))

    def named(self, spec: PartitionSpec) -> NamedSharding:
        return NamedSharding(self.mesh, spec)


def make_plan(mesh: Mesh, cfg: ModelConfig, mode: ExchangeMode,
              L: int = 0, train: bool = False,
              decode: bool = False) -> ShardingPlan:
    axes = list(mesh.axis_names)
    tp = "model"
    batch_axes = tuple(a for a in axes if a != tp)
    seq_axis = tp if mode in (ExchangeMode.PRISM, ExchangeMode.VOLTAGE) else None
    nbytes = _param_gb(cfg)
    # Training always shards params (ZeRO-3 over the batch axes): replicated
    # params replicate the f32 optimizer math and its temporaries too.
    # Inference replicates small archs (zero weight comm — paper layout).
    return ShardingPlan(mesh=mesh, mode=mode, batch_axes=batch_axes,
                        tp_axis=tp, seq_axis=seq_axis,
                        fsdp=train or nbytes > FSDP_THRESHOLD_GB, L=L,
                        decode=decode, train=train)


def _param_gb(cfg: ModelConfig) -> float:
    """Analytic parameter-byte estimate (for the FSDP threshold only)."""
    d, f, V, nl = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    per_layer = 4 * d * d + 3 * d * f
    if cfg.moe:
        m = cfg.moe
        per_layer = 4 * d * d + 3 * d * m.d_ff_expert * (m.n_experts + m.n_shared)
    total = nl * per_layer + 2 * V * d
    return total * 2 / 1e9


def axis_size(mesh: Mesh, axes) -> int:
    """The number of ranks an entry (a name or a tuple of names) spans."""
    if axes is None:
        return 1
    return int(np.prod([mesh.shape[a] for a in (
        axes if isinstance(axes, tuple) else (axes,))]))


def _divides(n: int, mesh: Mesh, axes) -> bool:
    if not axes:
        return False
    return n % axis_size(mesh, axes) == 0


def _fsdp_axes(plan: ShardingPlan, dim: int) -> Any:
    """Batch-axes (pod+data) sharding for a dim if enabled & divisible."""
    if not plan.fsdp:
        return None
    ax = plan.batch_axes if len(plan.batch_axes) > 1 else plan.batch_axes[0]
    return ax if _divides(dim, plan.mesh, ax) else None


def _leaf_spec(path: str, leaf, plan: ShardingPlan, cfg: ModelConfig,
               for_opt: bool = False) -> PartitionSpec:
    """Spec for one (possibly scan-stacked) parameter leaf.

    Layer params carry 1–2 leading *stack* dims; rules apply to the
    logical trailing dims and FSDP prefers the stack dim (per-layer
    just-in-time gather — ZeRO-3 granularity) falling back to the logical
    in-dim when the stack size doesn't divide the batch axes.
    """
    shape = leaf.shape
    mesh = plan.mesh
    tp = plan.tp_axis
    name = path.rsplit("/", 1)[-1]
    distributed = plan.seq_axis is not None

    if len(shape) <= 1:
        return P()

    def fsdp_ax(dim_size: int):
        return _fsdp_axes(plan, dim_size)

    # --- embeddings / unembedding (top-level, unstacked [V, D]) ------------
    # Feature dim stays replicated; the vocab dim shards over `model` in
    # LOCAL mode but over `data` in distributed modes — there the sequence
    # owns the model axis.
    if name in _EMBED:
        v_ax = None
        if not distributed and _divides(shape[0], mesh, tp):
            v_ax = tp
        elif distributed:
            for cand in plan.batch_axes[::-1]:
                if _divides(shape[0], mesh, cand):
                    v_ax = cand
                    break
        d_ax = None
        if for_opt:
            cands = [a for a in (plan.batch_axes + (tp,)) if a != v_ax]
            d_ax = next((a for a in cands if _divides(shape[1], mesh, a)),
                        None)
        elif distributed and not plan.train and _divides(shape[1], mesh, tp):
            # inference: 2-D shard the table
            d_ax = tp
        return P(v_ax, d_ax)

    # --- MoE expert weights: [..., E, D, F] / [..., E, F, D] ----------------
    if "moe/" in path and name in ("w_gate", "w_up", "w_down"):
        stack = len(shape) - 3
        e_ax = tp if _divides(shape[stack], mesh, tp) else None
        inner = fsdp_ax(shape[stack + 1])
        spec = [None] * stack + [e_ax, inner, None]
        return P(*spec)

    # --- MLA up-projections [..., r, H, dh] ---------------------------------
    if name in ("w_uk", "w_uv"):
        stack = len(shape) - 3
        head_ax = (tp if (not distributed
                          and _divides(shape[stack + 1], mesh, tp)) else None)
        r_ax = fsdp_ax(shape[stack]) if (plan.fsdp or for_opt) else None
        return P(*([None] * stack), r_ax, head_ax, None)

    # --- xLSTM sLSTM recurrent [4, H, dh, dh] (unstackable, small) ----------
    if name == "r":
        return P()

    def dense_spec(kind: str):
        """kind: 'col' (out dim TP) | 'row' (in dim TP)."""
        d_in, d_out = shape[-2], shape[-1]
        tp_ok_out = _divides(d_out, mesh, tp)
        tp_ok_in = _divides(d_in, mesh, tp)
        # TP uses the model axis only in LOCAL mode (in distributed modes
        # the model axis carries the sequence), and in decode for the
        # non-attention weights.
        use_tp = (not distributed) or (plan.decode and name not in _ATTN)
        col_ax = tp if (use_tp and kind == "col" and tp_ok_out) else None
        row_ax = tp if (use_tp and kind == "row" and tp_ok_in) else None
        # FSDP: shard a LOGICAL dim (never the stack dim of a matrix)
        spec = [None] * len(shape)
        if kind == "col" and col_ax is not None:
            spec[-1] = col_ax
        if kind == "row" and row_ax is not None:
            spec[-2] = row_ax
        if plan.fsdp or for_opt:
            if kind == "col" and fsdp_ax(d_in) is not None:
                spec[-2] = fsdp_ax(d_in)
            elif kind == "row" and spec[-1] is None and fsdp_ax(d_out) is not None:
                spec[-1] = fsdp_ax(d_out)
            elif spec[-1] is None and fsdp_ax(d_out) is not None:
                spec[-1] = fsdp_ax(d_out)
        if for_opt:
            # optimizer state additionally shards the other logical dim over
            # the model axis (ZeRO-1): the update is elementwise.
            if kind == "col" and spec[-1] is None and tp_ok_out:
                spec[-1] = tp
            elif kind == "row" and spec[-2] is None and tp_ok_in:
                spec[-2] = tp
        return P(*spec)

    if name in _ROW:
        return dense_spec("row")
    if name in _COL or name in _ATTN or len(shape) >= 2:
        return dense_spec("col")
    return P()


def _opt_force_data(spec: PartitionSpec, leaf,
                    plan: ShardingPlan) -> PartitionSpec:
    """ZeRO-1: ensure optimizer state is sharded over the batch axes on some
    dim even when the param itself is replicated."""
    if any(s is not None for s in spec):
        return spec
    shape = leaf.shape
    if len(shape) == 0:
        return P()
    ax = plan.batch_axes if len(plan.batch_axes) > 1 else (
        plan.batch_axes[0] if plan.batch_axes else None)
    if ax is None:
        return spec
    for i, dim in enumerate(shape):
        if _divides(dim, plan.mesh, ax):
            return P(*([None] * i), ax)
    return spec


def jax_layout_shapes(params, cfg: ModelConfig) -> Dict[str, Shape]:
    """Every leaf of the port's ``params`` keyed and shaped as in the JAX
    package's layout: a stack's per-layer leaves as one leaf with the layers
    on its leading dims (``transformer.layer_stacks``: ``lead`` dims, and
    one more for an inner stack), keyed by its path with the list indices
    dropped (``"layers/attn/wq"``)."""
    from repro_torch.sharding.placement import stack_index
    return {key: Shape(ent.shape)
            for key, ent in stack_index(params, cfg).items()}


def param_shardings(plan: ShardingPlan, cfg: ModelConfig, params
                    ) -> Dict[str, NamedSharding]:
    """JAX-layout key → NamedSharding, for the port's (abstract) params."""
    return {k: plan.named(_leaf_spec(k, leaf, plan, cfg))
            for k, leaf in jax_layout_shapes(params, cfg).items()}


def opt_state_shardings(plan: ShardingPlan, cfg: ModelConfig, params
                        ) -> Dict[str, NamedSharding]:
    def spec(k, leaf):
        s = _leaf_spec(k, leaf, plan, cfg, for_opt=True)
        return plan.named(_opt_force_data(s, leaf, plan))
    return {k: spec(k, leaf)
            for k, leaf in jax_layout_shapes(params, cfg).items()}


def _batch_ax(plan: ShardingPlan, dim: int):
    """Largest batch-axes group that divides ``dim`` (None if none does)."""
    cands = []
    if len(plan.batch_axes) > 1:
        cands.append(plan.batch_axes)
    cands.extend(plan.batch_axes)
    for c in cands:
        if _divides(dim, plan.mesh, c):
            return c
    return None


def _seq_ax(plan: ShardingPlan, dim: int):
    if plan.seq_axis and _divides(dim, plan.mesh, plan.seq_axis):
        return plan.seq_axis
    return None


def _paths(tree, prefix: str = ""):
    """(``/``-joined key path, leaf) of a dict tree (None: no leaf)."""
    from repro_torch.utils.tree import tree_leaves_with_paths
    return [("/".join(str(p) for p in path), leaf)
            for path, leaf in tree_leaves_with_paths(tree)]


def batch_shardings(plan: ShardingPlan, cfg: ModelConfig, specs,
                    kind: str) -> Dict[str, NamedSharding]:
    """Shardings for the input batch dict (tokens / labels / frames / ...);
    ``specs``: name → anything with a ``shape`` (``registry.input_specs``'
    ``TensorSpec``, a tensor)."""

    def one(name, leaf):
        nd = len(leaf.shape)
        bax = _batch_ax(plan, leaf.shape[0])
        if "tokens" in name or "labels" in name:
            if kind == "decode" or nd < 2 or leaf.shape[1] == 1:
                return plan.named(P(bax, None))
            return plan.named(P(bax, _seq_ax(plan, leaf.shape[1])))
        if "frames" in name or "image_embeds" in name:
            # memory: batch over data; its length is padded and partitioned
            # inside the model, so the raw input is replicated on seq.
            return plan.named(P(bax, None, None))
        if "images" in name:
            return plan.named(P(bax, None, None, None))
        return plan.named(P(*([bax] + [None] * (nd - 1))))

    return {name: one(name, leaf) for name, leaf in specs.items()}


def cache_shardings(plan: ShardingPlan, cfg: ModelConfig, cache
                    ) -> Dict[str, NamedSharding]:
    """Decode-cache shardings, ``/``-joined key path → NamedSharding, on
    the JAX layout of the port's cache (``_cache_layout``):
    [layers, B, S, ...] — batch over (pod, data), sequence over the model
    axis (flash-decoding merge), recurrent states batch-sharded only."""

    def one(name, leaf):
        nd = len(leaf.shape)
        if "mem_mask" in name:                     # [B, M]
            return plan.named(P(_batch_ax(plan, leaf.shape[0]),
                                _seq_ax(plan, leaf.shape[1])))
        if "mem_kv" in name:                       # [layers, B, M, Hk, dh]
            return plan.named(P(None, _batch_ax(plan, leaf.shape[1]),
                                _seq_ax(plan, leaf.shape[2]), None, None))
        if any(k in name for k in ("/k", "/v", "c_kv", "k_pe")) and nd >= 3:
            # [layers(, inner), B, S, ...] — S right after batch
            lead = 2 if nd > 5 else 1
            spec = [None] * nd
            spec[lead] = _batch_ax(plan, leaf.shape[lead])
            spec[lead + 1] = _seq_ax(plan, leaf.shape[lead + 1])
            return plan.named(P(*spec))
        # recurrent states: xlstm mLSTM stacks are [groups, n_m, B, ...]
        bdim = 2 if name.startswith("m/") else 1
        spec = [None] * nd
        if nd > bdim:
            spec[bdim] = _batch_ax(plan, leaf.shape[bdim])
        return plan.named(P(*spec))

    return {name: one(name, Shape(_cache_layout(cfg, name, leaf.shape)))
            for name, leaf in _paths(cache)}


def _cache_layout(cfg: ModelConfig, name: str, shape) -> Tuple[int, ...]:
    """A cache leaf's shape in the JAX layout: the vlm's self-attention
    half holds its layers as ``[n_groups, k − 1, ...]`` there, one flat
    stack in the port."""
    if cfg.family == "vlm" and name.startswith("self/"):
        k = cfg.cross_attn_every - 1
        return (shape[0] // k, k) + tuple(shape[1:])
    return tuple(shape)
