"""One rank's shards of a model's parameters and optimizer state under a
``ShardingPlan``: the runtime half of ``repro_torch.sharding``, the port's
counterpart of ``jax.device_put`` with the plan's shardings and of the
collectives GSPMD inserts around them.

Every leaf lives in the JAX package's layout (``stack_index``: a stack's
per-layer leaves as one leaf with the layers on its leading dims, keyed
``"layers/attn/wq"``), and a rank holds the block of it that its mesh
coordinates select under the leaf's spec (``Placement.index``): an entry
on a stack dim selects layers, an entry on a logical dim a slice of it.
Parameters are held as their param-spec blocks between train steps and
the optimizer's moments as their (finer) optimizer-spec blocks; a step

1. runs the model on a ``LayerView`` of the blocks: each layer gathers
   its leaves over the axes their specs shard them on as the model
   reaches it (ZeRO-3's just-in-time gather, inside the layer's
   rematerialised region: one staged call over ``data`` for the layer,
   booked as ``param``, then one over ``model`` for the leaves the rank
   runs whole or as ranges of another block), and the top-level leaves
   (the embedding, the final norm, the head) where they are used; the
   gathered layer is freed when the layer ends, the recompute gathers it
   again, and a rank never holds more than its blocks and one layer;
2. sums the gradients over the mesh: as the backward leaves a layer, its
   gathers' transposes reduce-scatter the layer's f32 gradient over
   ``data`` where the batch is sharded there (each rank keeps its block's
   sum, ``grad``), and over the row (the ``model`` axis: the sequence
   parts) for a leaf gathered there (the MoE experts); at the end of the
   step (``reduce_gradients``) an f32 ``all_reduce`` over the row of the
   other leaves and, over the batch axes, one for the leaves the plan
   replicates there (``grad``);
3. updates each optimizer block (``train.optimizer``) and gathers the
   updated blocks back into the param-spec blocks over the axes the
   optimizer spec adds (``param``).

The serving steps of a plan with ``fsdp`` take the rank's blocks and
gather each layer the same way, without grad.

Under tensor parallelism (``repro_torch.models.tp``: a ``local`` plan
with a model axis over 1, or a decode plan's MLPs and experts) a rank
computes with its block of the TP leaves (``tp_dim``: the split heads'
``wq/wk/wv/wo`` and MLA's ``w_uq/w_uk/w_uv/wo`` and latent projections,
the split MLPs, the experts, the vocabulary, the recurrent mixers'
channels), so a layer gathers those over ``data`` only and every other
leaf whole; the model then runs inside ``tp_context``.  The
stored blocks stay the JAX spec's; where the rank's block is not its
model block (``moved``: heads split unevenly, columns the axis does not
divide, a mixer's block of several ranges of a dim, or of a dim the spec
does not split) the leaf is gathered over ``data``, then over ``model``,
and the rank's ranges joined from it (``param``), and its gradient goes
back the reverse way, padded whole and reduce-scattered over the row
(``grad``), which also sums a range that several ranks hold (the
mLSTM's x half of ``w_up``).  The row's ranks hold the same loss, so
the row sums only the gradients that are a rank's part (``sliced``: the
qkv biases of split heads, a shared KV head's ``wk/wv``, the mLSTM's
``w_q/w_k/w_if/b_if``, a gathered MLA latent's norm; in the model
gather's backward where the leaf is gathered over the row, else at the
end of the step); a TP leaf's gradient is its block's, and a leaf
consumed whole has the same gradient on every rank of the row (the model
gather's backward keeps the rank's block of it).

The runtime takes ``("data", "model")`` and ``("pod", "data",
"model")`` meshes.  On the second the plan shards the batch and the ZeRO-3
params over the batch axes ``("pod", "data")`` together (one entry, one
group: ``launch.mesh.group_axes``), and what the text above says of
``data`` holds of the batch axes.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.models import tp as tpm
from repro_torch.utils.tree import (tree_leaves_with_paths,
                                    tree_unflatten_like)


Ranges = Tuple[Tuple[int, int], ...]     # a block: [start, stop) ranges


def _lead_shape(st, cfg) -> Tuple[int, ...]:
    """The leading dims that hold a stack's layers in the JAX layout."""
    if st.lead == 1:
        return (st.depth,)
    per = cfg.cross_attn_every - 1           # the vlm's [groups, k − 1]
    return (st.depth // per, per)


class Stacked(NamedTuple):
    """One JAX-layout leaf of a port tree."""
    shape: Tuple[int, ...]     # stacked: the lead dims, then a layer's leaf
    dtype: torch.dtype
    paths: List[tuple]         # the port key paths of its per-layer leaves
    lead: int                  # how many of ``shape``'s dims hold layers


def stack_index(params, cfg) -> Dict[str, Stacked]:
    """JAX-layout key → its ``Stacked`` entry: the port key paths of its
    per-layer leaves in the row-major order of the stack dims (one path and
    no lead dim for a leaf outside the stacks)."""
    from repro_torch.models.transformer import layer_stacks
    stacks = {st.name: st for st in layer_stacks(cfg)}
    out: Dict[str, list] = {}
    for top in sorted(params):
        sub = params[top]
        if top not in stacks:
            for path, leaf in tree_leaves_with_paths(sub, (top,)):
                out["/".join(map(str, path))] = [tuple(leaf.shape),
                                                 leaf.dtype, [path], ()]
            continue
        st = stacks[top]
        for i, layer in enumerate(sub):
            for path, leaf in tree_leaves_with_paths(layer, (top, i)):
                inner = path[2] in st.inner
                rest = path[4:] if inner else path[2:]
                key = "/".join(map(str, (top,) + ((path[2],) if inner
                                                  else ()) + rest))
                lead = _lead_shape(st, cfg) + (
                    (st.inner[path[2]],) if inner else ())
                ent = out.setdefault(key, [tuple(leaf.shape), leaf.dtype,
                                           [], lead])
                ent[2].append(path)
    return {k: Stacked(lead + shape, dtype, paths, len(lead))
            for k, (shape, dtype, paths, lead) in out.items()}


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _entry(spec, i: int):
    """Entry ``i`` of ``spec`` (None past its end: a spec may be shorter
    than its leaf's dims)."""
    return spec[i] if i < len(spec) else None


def spec_axes(spec) -> set:
    return {a for e in spec for a in _entry_axes(e)}


class Placement:
    """This rank's blocks, under ``plan``, of every leaf of a model whose
    port params are shaped as ``template`` (a tree on any device; the meta
    device allocates nothing: ``registry.abstract_params``).

    ``coords`` (axis name → index) defaults to the mesh this process
    joined (``launch.mesh.set_mesh``)."""

    def __init__(self, plan, cfg, template, coords: Optional[Dict[str, int]]
                 = None):
        from repro_torch.sharding.specs import (Shape, _leaf_spec,
                                                _opt_force_data)
        mesh = plan.mesh
        if mesh.axis_names[-1] != "model":
            raise NotImplementedError(
                f"the port runs meshes whose last axis is 'model' (('data', "
                f"'model'), ('pod', 'data', 'model')); not {mesh}")
        self.plan, self.cfg, self.mesh = plan, cfg, mesh
        self.tp = tpm.plan_of(plan, cfg)
        if coords is None:
            from repro_torch.launch.mesh import mesh_coords
            coords = mesh_coords()
        self.coords = dict(coords)
        self.template = template
        self.order = {path: i for i, (path, _) in
                      enumerate(tree_leaves_with_paths(template))}
        self.index_of = stack_index(template, cfg)
        self.keys = list(self.index_of)
        self.spec, self.opt_spec = {}, {}
        for k, ent in self.index_of.items():
            leaf = Shape(ent.shape)
            self.spec[k] = _leaf_spec(k, leaf, plan, cfg)
            self.opt_spec[k] = _opt_force_data(
                _leaf_spec(k, leaf, plan, cfg, for_opt=True), leaf, plan)
            if plan.train and any(p is not None and p != o for p, o in
                                  zip(self.spec[k], self.opt_spec[k])):
                raise ValueError(f"{k}: optimizer spec {self.opt_spec[k]} "
                                 f"does not refine the param spec "
                                 f"{self.spec[k]}")
        # the TP leaves → their split dim; those whose block is not the
        # stored model block → the block's ranges of that dim; the leaves
        # whose gradient is the rank's part
        self.tp_dim: Dict[str, int] = {}
        self.moved: Dict[str, Ranges] = {}
        self.sliced: Dict[str, int] = {}
        if self.tp is not None:
            r = self.coords["model"]
            for k, ent in self.index_of.items():
                blk = self.tp.leaf_block(k, ent.shape, cfg, r)
                if blk is not None:
                    dim, ranges = blk
                    self.tp_dim[k] = dim
                    n, M = ent.shape[dim], self.tp.M
                    if _entry(self.spec[k], dim) != "model" or \
                            ranges != ((r * n // M, (r + 1) * n // M),):
                        self.moved[k] = ranges
                dim = self.tp.sliced_dim(k, ent.shape, cfg, r)
                if dim is not None:
                    self.sliced[k] = dim
        # the block a TP leaf is gathered to (and its gradient reduced
        # from): its model block where the spec has one, else the whole
        self.held = {k: tuple("model" if i == self.tp_dim.get(k)
                              and _entry(self.spec[k], i) == "model" else None
                              for i in range(len(self.index_of[k].shape)))
                     for k in self.keys}

    # --- blocks -----------------------------------------------------------

    def _pos(self, entry) -> Tuple[int, int]:
        """(this rank's index along ``entry``'s axes, their count)."""
        idx, n = 0, 1
        for a in _entry_axes(entry):
            size = self.mesh.shape[a]
            idx, n = idx * size + self.coords[a], n * size
        return idx, n

    def index(self, key: str, spec) -> Tuple[slice, ...]:
        """This rank's block of leaf ``key`` under ``spec``, as slices of
        the global (stacked) array."""
        shape = self.index_of[key].shape
        out = []
        for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
            i, n = self._pos(entry)
            out.append(slice(i * dim // n, (i + 1) * dim // n))
        return tuple(out)

    def block_shape(self, key: str, spec) -> Tuple[int, ...]:
        return tuple(s.stop - s.start for s in self.index(key, spec))

    def counted(self, key: str, spec) -> bool:
        """Does this rank count its block of ``key`` in a sum over the mesh
        (the first of the ranks that hold the same block)?"""
        used = spec_axes(spec)
        return all(self.coords[a] == 0 for a in self.mesh.axis_names
                   if a not in used)

    def _relative(self, key: str, inner, outer) -> Tuple[slice, ...]:
        """Block ``inner``'s slices inside block ``outer`` (both of key)."""
        return tuple(slice(a.start - b.start, a.stop - b.start)
                     for a, b in zip(self.index(key, inner),
                                     self.index(key, outer)))

    # --- the port tree ↔ the JAX layout ------------------------------------

    def stack(self, tree, dtype=None) -> Dict[str, torch.Tensor]:
        """The port tree ``tree`` (params or gradients, shaped as the
        template) → JAX-layout key → the whole stacked leaf (one copy, in
        ``dtype`` if given)."""
        leaves = [leaf for _, leaf in tree_leaves_with_paths(tree)]
        return {k: self._stack_one(k, leaves, dtype) for k in self.keys}

    def _stack_one(self, k: str, tree, dtype=None) -> torch.Tensor:
        """``stack``'s leaf ``k`` (``tree``: the port tree, or its
        leaves)."""
        leaves = tree if isinstance(tree, list) else \
            [leaf for _, leaf in tree_leaves_with_paths(tree)]
        ent = self.index_of[k]
        parts = [leaves[self.order[p]] for p in ent.paths]
        t = torch.empty((len(parts),) + tuple(parts[0].shape),
                        dtype=dtype or parts[0].dtype, device=parts[0].device)
        for j, part in enumerate(parts):
            t[j].copy_(part)
        return t.reshape(ent.shape[:ent.lead] + tuple(parts[0].shape))

    def unstack(self, flat: Dict[str, torch.Tensor]):
        """``stack``'s inverse: the port tree whose leaves are views of
        ``flat``'s leaves (whole, or the blocks the model runs on)."""
        leaves: List[Any] = [None] * len(self.order)
        for k, ent in self.index_of.items():
            parts = flat[k].reshape((len(ent.paths),)
                                    + tuple(flat[k].shape[ent.lead:]))
            for j, p in enumerate(ent.paths):
                leaves[self.order[p]] = parts[j]
        return tree_unflatten_like(self.template, leaves)

    def opt_part(self, blocks: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """Param-spec blocks → the optimizer-spec blocks inside them
        (views)."""
        return {k: blocks[k][self._relative(k, self.opt_spec[k],
                                            self.spec[k])]
                for k in self.keys}

    # --- collectives ------------------------------------------------------

    @staticmethod
    def _group(axes):
        """The seq group of an axis, or of a tuple of axes (a spec
        entry)."""
        from repro_torch.core.seq_group import get_seq_group
        from repro_torch.launch.mesh import group_name
        return get_seq_group(group_name(axes))

    def _gather_dim(self, t: torch.Tensor, spec: list, k: int
                    ) -> torch.Tensor:
        """Gather ``t`` (a block under ``spec``) over the axes of entry
        ``spec[k]``: the blocks of the entry's line, joined along dim
        ``k``; ``spec`` loses the entry."""
        g = self._group(spec[k])
        spec[k] = None
        if g.world_size == 1:
            return t
        parts = g.all_gather(t.contiguous(), kind="param")
        return torch.cat(list(parts.unbind(0)), dim=k)

    def _gather_leaf(self, t: torch.Tensor, spec, keep=()) -> torch.Tensor:
        """Block ``t`` under ``spec`` gathered over each entry it is
        sharded on whose axes are not in ``keep`` (the entry holding the
        ``model`` axis first, then in reverse axis order)."""
        spec = list(spec)
        for axis in reversed(self.mesh.axis_names):
            k = next((i for i, e in enumerate(spec)
                      if axis in _entry_axes(e)), None)
            if k is not None and not set(_entry_axes(spec[k])) & set(keep):
                t = self._gather_dim(t, spec, k)
        return t

    def gather(self, blocks: Dict[str, torch.Tensor], specs, target=None
               ) -> Dict[str, torch.Tensor]:
        """Blocks under ``specs`` → blocks under ``target`` (default:
        whole leaves), gathering over every axis ``specs`` shards a leaf on
        and ``target`` does not (the ``model`` axis first); booked as
        ``param`` on each axis's group."""
        return {k: self._gather_leaf(
            blocks[k], specs[k],
            spec_axes(target[k]) if target is not None else ())
            for k in self.keys}

    def _plan(self, k: str, whole: bool) -> "_LeafPlan":
        """How a layer's leaf ``k`` goes from the rank's block to what the
        model runs on (every leaf whole with ``whole``, else the TP leaves
        the rank's blocks)."""
        ent, spec = self.index_of[k], self.spec[k]
        n = len(ent.shape)
        held = (None,) * n if whole else self.held[k]
        ranges = None if whole else self.moved.get(k)
        bdim = self._batch_dim(k)
        batch = None if bdim is None else (bdim, spec[bdim])
        mdim = next((i for i in range(n)
                     if "model" in _entry_axes(_entry(spec, i))), None)
        if mdim is not None and mdim < ent.lead:
            raise NotImplementedError(f"{k}: a stack dim over 'model'")
        if mdim is not None and held[mdim] == "model" and ranges is None:
            mdim = None                        # the rank's model block
        # the row's ranks read a leaf gathered over ``model`` with their own
        # part of the loss: every leaf without TP (each rank its part of
        # the sequence), a moved or sliced one under TP
        return _LeafPlan(ent.lead, batch, mdim, ranges,
                         self.tp_dim.get(k),
                         self.tp is None or (not whole and (
                             k in self.moved or k in self.sliced)))

    def _model_summed(self, k: str) -> bool:
        """Does the backward of ``k``'s model gather sum it over the row?"""
        plan = self._plan(k, False)
        return plan.model is not None and plan.model_sum

    def layer_view(self, blocks: Dict[str, torch.Tensor], *,
                   grad: bool = False, whole: bool = False,
                   batch_entry=None) -> "LayerView":
        """The port tree over this rank's param-spec ``blocks`` that the
        model runs on one layer at a time (``LayerView``).  ``grad``: its
        leaves require grad (a train step; ``batch_entry``, the batch axes
        the rows are sharded over, says where a gather's backward sums);
        ``whole``: every leaf gathered whole (a full sequence over the row
        under a decode plan), else the TP leaves as the rank's blocks."""
        return LayerView(self, blocks, grad, whole, batch_entry)

    def param_blocks(self, params) -> Dict[str, torch.Tensor]:
        """Whole port ``params`` (the same on every rank) → this rank's
        param-spec blocks, one stacked leaf at a time."""
        leaves = [leaf for _, leaf in tree_leaves_with_paths(params)]
        out = {}
        for k in self.keys:
            whole = self._stack_one(k, leaves)
            out[k] = whole[self.index(k, self.spec[k])].clone()
            del whole
        return out

    def held_index(self, k: str) -> tuple:
        """The block of whole leaf ``k`` the model runs on (whole on the
        stack dims): slices, and for a block of several ranges the list of
        its indices along its dim."""
        if k not in self.moved:
            return self.index(k, self.held[k])
        idx: list = [slice(None)] * len(self.index_of[k].shape)
        ranges = self.moved[k]
        idx[self.tp_dim[k]] = slice(*ranges[0]) if len(ranges) == 1 else \
            [i for lo, hi in ranges for i in range(lo, hi)]
        return tuple(idx)

    def held_shape(self, k: str) -> Tuple[int, ...]:
        """The shape of the block of leaf ``k`` the model runs on."""
        return tuple(len(range(n)[i]) if isinstance(i, slice) else len(i)
                     for n, i in zip(self.index_of[k].shape,
                                     self.held_index(k)))

    def held_params(self, params):
        """Whole port ``params`` (the same on every rank) → the tree the
        model runs on, sliced locally: each TP leaf's block, every other
        leaf whole (no collective; serving's view of the plan), one
        per-layer leaf at a time."""
        leaves = [leaf for _, leaf in tree_leaves_with_paths(params)]
        out: List[Any] = [None] * len(self.order)
        for k, ent in self.index_of.items():
            idx = self.held_index(k)[ent.lead:]
            for p in ent.paths:
                out[self.order[p]] = leaves[self.order[p]][idx].clone()
        return tree_unflatten_like(self.template, out)

    def _widen(self, k: str, t: torch.Tensor) -> torch.Tensor:
        """TP leaf ``k``'s block (the rank's) → the whole leaf, gathered
        over ``model`` by the true block sizes (each padded to the largest
        for the gather) and each rank's ranges put in place."""
        dim = self.tp_dim[k]
        if k not in self.moved:
            return self._gather_dim(t, list(self.held[k]), dim)
        row = self._group("model")
        blocks = [self.tp.leaf_block(k, self.index_of[k].shape, self.cfg,
                                     i)[1] for i in range(row.world_size)]
        sizes = [sum(hi - lo for lo, hi in b) for b in blocks]
        pad = list(t.shape)
        pad[dim] = max(sizes)
        buf = t.new_zeros(pad)
        buf.narrow(dim, 0, t.shape[dim]).copy_(t)
        parts = row.all_gather(buf, kind="param")
        shape = list(t.shape)
        shape[dim] = self.index_of[k].shape[dim]
        whole = t.new_empty(shape)
        for part, ranges in zip(parts.unbind(0), blocks):
            at = 0
            for lo, hi in ranges:
                whole.narrow(dim, lo, hi - lo).copy_(
                    part.narrow(dim, at, hi - lo))
                at += hi - lo
        return whole

    def widened(self, params):
        """The tree the model runs on → every leaf whole: the TP leaves
        gathered over ``model`` (booked as ``param``), for a step that
        runs the sequence over the row (a prefill under a decode plan
        over the sequence)."""
        flat = self.stack(params)
        return self.unstack({k: self._widen(k, t) if k in self.tp_dim
                             else t for k, t in flat.items()})

    def tp_context(self, batch_entry=None):
        """The context to run the model in (``models.tp.on_mesh``): TP
        over the row as the plan says, and the group of ``batch_entry``
        (the batch axes the rows are sharded over, ``batch_entry``; None:
        not sharded) for the moe aux loss's routing sums."""
        return tpm.on_mesh(
            self.tp, self._group("model") if self.tp is not None else None,
            self._group(batch_entry) if batch_entry is not None else None)

    def assemble(self, opt_blocks: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """Updated optimizer-spec blocks → param-spec blocks."""
        return self.gather(opt_blocks, self.opt_spec, self.spec)

    def batch_entry(self, batch: Dict[str, Any]):
        """The batch axes (an axis name or a tuple of them) the plan
        shards this global batch's rows over, where they span more than
        one rank; else None."""
        from repro_torch.sharding.specs import axis_size, batch_shardings
        sh = batch_shardings(self.plan, self.cfg, batch, "train")
        entry = sh["tokens"].spec[0]
        return entry if axis_size(self.mesh, entry) > 1 else None

    def batch_sharded(self, batch: Dict[str, Any]) -> bool:
        """Does the plan shard this global batch over the batch axes (its
        rows divide)?"""
        return self.batch_entry(batch) is not None

    def batch_part(self, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """This rank's rows of the global batch (every rank of a row the
        same rows: the sequence splits inside the model)."""
        entry = self.batch_entry(batch)
        if entry is None:
            return batch
        i, n = self._pos(entry)
        return {k: v[i * v.shape[0] // n:(i + 1) * v.shape[0] // n]
                for k, v in batch.items()}

    def _batch_dim(self, key: str) -> Optional[int]:
        """The dim of leaf ``key``'s param spec sharded over batch axes
        only (``data``, or ``("pod", "data")``), or None."""
        for i, e in enumerate(self.spec[key]):
            axes = _entry_axes(e)
            if axes and "model" not in axes:
                return i
        return None

    def reduce_gradients(self, grads: Dict[str, torch.Tensor],
                         batch_entry=None) -> Dict[str, torch.Tensor]:
        """The f32 gradients of this rank's param-spec blocks after the
        backward of a ``LayerView`` (each already summed over the batch
        axes of its gather where ``batch_entry`` shards the rows there, and
        over the row where its model gather sums) → the sums over the mesh
        of this rank's optimizer-spec blocks.  What is left is summed here,
        each an f32 ``all_reduce`` booked as ``grad``: over the row (the
        ``model`` axis) the sequence parts of every leaf not gathered over
        it, or under TP the ``sliced`` and ``moved`` leaves whose model
        gather did not sum them; over the batch axes of ``batch_entry``
        that a leaf's gather did not reduce-scatter over (all of them for
        a leaf the plan replicates there)."""
        row = self._group("model")
        summed = [k for k in (self.keys if self.tp is None else
                              sorted(set(self.sliced) | set(self.moved)))
                  if not self._model_summed(k)]
        if row.world_size > 1 and summed:
            grads.update(zip(summed, row.all_reduce(
                [grads[k] for k in summed], kind="grad")))
        S = _entry_axes(batch_entry)
        rest: Dict[tuple, List[str]] = {}
        for k in self.keys if S else ():
            E = _entry_axes(self._plan(k, False).batch_entry)
            A = tuple(a for a in S if a not in E) if set(E) <= set(S) else S
            if A and self._group(A).world_size > 1:
                rest.setdefault(A, []).append(k)
        for A, keys in rest.items():
            grads.update(zip(keys, self._group(A).all_reduce(
                [grads[k] for k in keys], kind="grad")))
        return self.opt_part(grads)

    def sum_over_mesh(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over every rank of the mesh (the row, then the
        column; ``meta`` calls), the same bits on every rank."""
        for axis in reversed(self.mesh.axis_names):
            g = self._group(axis)
            if g.world_size > 1:
                t = g.all_reduce([t], kind="meta")[0]
        return t

    def global_norm(self, opt_grads: Dict[str, torch.Tensor]
                    ) -> torch.Tensor:
        """The norm of the whole gradient from this rank's optimizer
        blocks: each distinct block's squares counted once, summed over the
        mesh, then the square root."""
        sq = sum((torch.sum(torch.square(opt_grads[k].float()))
                  for k in self.keys if self.counted(k, self.opt_spec[k])),
                 torch.zeros((), dtype=torch.float32,
                             device=next(iter(opt_grads.values())).device))
        return torch.sqrt(self.sum_over_mesh(sq))

    # --- state: init, checkpoints -------------------------------------------

    def init_state(self, params, moment_dtype=torch.float32):
        """Whole port ``params`` (the same on every rank) → (this rank's
        param-spec blocks, an AdamW state of its optimizer-spec blocks)."""
        from repro_torch.train.optimizer import adamw_init
        blocks = self.param_blocks(params)
        return blocks, adamw_init(
            {k: v.clone() for k, v in self.opt_part(blocks).items()},
            moment_dtype)

    def whole(self, blocks: Dict[str, torch.Tensor], specs,
              to_host: bool = False) -> Dict[str, torch.Tensor]:
        """Whole leaves from every rank's blocks under ``specs``, one leaf
        at a time; with ``to_host`` each is moved to host memory at once
        (on the card only one whole leaf lives at a time)."""
        out = {}
        for k in self.keys:
            t = self._gather_leaf(blocks[k], specs[k])
            out[k] = t.cpu() if to_host else t
        return out

    def save(self, manager, blocks, opt_state, step: int) -> None:
        """Checkpoint the mesh's state as global arrays in the JAX layout:
        every rank gathers its blocks, rank 0 writes ``(params,
        AdamWState(step, m, v))`` (asynchronously, ``manager.save_async``;
        ``manager`` is None on the other ranks)."""
        from repro_torch.train.optimizer import AdamWState
        state = (self.whole(blocks, self.spec, to_host=True),
                 AdamWState(opt_state.step.cpu(),
                            self.whole(opt_state.m, self.opt_spec, True),
                            self.whole(opt_state.v, self.opt_spec, True)))
        if manager is not None:
            manager.save_async(state, step)

    def state_template(self, moment_dtype=torch.float32):
        """The checkpoint's tree (meta leaves) and this rank's placements
        in it: ``restore(template, placements=...)`` → (param-spec blocks,
        AdamW state of optimizer-spec blocks)."""
        from repro_torch.train.optimizer import AdamWState
        meta = torch.device("meta")

        def leaves(dtype=None):
            return {k: torch.empty(e.shape, dtype=dtype or e.dtype,
                                   device=meta)
                    for k, e in self.index_of.items()}
        template = (leaves(), AdamWState(
            torch.empty((), dtype=torch.int32, device=meta),
            leaves(moment_dtype), leaves(moment_dtype)))
        places = {f"0/{k}": self.index(k, self.spec[k]) for k in self.keys}
        for part in ("m", "v"):
            places.update({f"1/.{part}/{k}": self.index(k, self.opt_spec[k])
                           for k in self.keys})
        return template, places

    def decay(self) -> Dict[str, bool]:
        """AdamW's decoupled-decay rule in the JAX layout: ndim ≥ 2."""
        return {k: len(self.index_of[k].shape) >= 2 for k in self.keys}


class _LeafPlan(NamedTuple):
    """How one leaf of a ``LayerView`` reaches the model (dims of the
    stacked leaf)."""
    lead: int                           # its stack dims
    batch: Optional[Tuple[int, Any]]    # (dim, entry) over the batch axes
    model: Optional[int]                # the dim gathered over ``model``
    ranges: Optional[Ranges]            # a moved leaf's ranges of tp_dim
    tp_dim: Optional[int]
    model_sum: bool                     # the model gather's backward sums

    @property
    def batch_entry(self):
        return None if self.batch is None else self.batch[1]


def _unravel(j: int, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    out = []
    for n in reversed(shape):
        out.append(j % n)
        j //= n
    return tuple(reversed(out))


class LayerView:
    """A rank's param-spec blocks as the port tree the model runs on, one
    layer at a time (ZeRO-3's just-in-time gather).

    ``tree`` holds, at each per-layer leaf, the rank's block of that
    layer's leaf (a view of ``blocks``; a leaf whose stack dim the plan
    shards over the batch axes is a layer some rank owns whole: on the
    others an empty stand-in), and at each top-level leaf its block.
    Calling the view on a subtree of ``tree`` (``remat.gathered``, inside
    ``remat.gathering(view)``) gathers its leaves: one staged call over
    the batch axes (a stack-sharded row from the rank that owns it), then
    one over ``model`` for the leaves the rank runs whole (or as ranges of
    the whole, ``Placement.moved``), each ``SeqGroup.gather_blocks``,
    whose backward reduce-scatters the gradient (``grad``) where the rows
    are sharded over those axes."""

    def __init__(self, place: Placement, blocks: Dict[str, torch.Tensor],
                 grad: bool, whole: bool, batch_entry):
        self.place, self.grad = place, grad
        self.S = _entry_axes(batch_entry)
        self.plans = {k: place._plan(k, whole) for k in place.keys}
        self._where: Dict[int, Tuple[str, Tuple[int, ...], bool]] = {}
        self.slots: Dict[str, List[Tuple[int, tuple]]] = {}
        leaves: List[Any] = [None] * len(place.order)
        for k, ent in place.index_of.items():
            blk = blocks[k]
            idx = place.index(k, place.spec[k])[:ent.lead]
            for j, p in enumerate(ent.paths):
                mi = _unravel(j, ent.shape[:ent.lead])
                owned = all(s.start <= m < s.stop for s, m in zip(idx, mi))
                if owned:
                    local = tuple(m - s.start for s, m in zip(idx, mi))
                    t = blk[local].detach()
                    t.requires_grad_(grad and t.is_floating_point())
                    self.slots.setdefault(k, []).append((place.order[p],
                                                         local))
                else:
                    t = torch.empty((0,), dtype=blk.dtype, device=blk.device,
                                    requires_grad=grad)
                leaves[place.order[p]] = t
                self._where[id(t)] = (k, mi, owned)
        self._leaves = leaves
        self.tree = tree_unflatten_like(place.template, leaves)

    def __call__(self, tree):
        leaves = tree_leaves_with_paths(tree)
        out = [leaf for _, leaf in leaves]
        todo = {i: self._where[id(t)] for i, t in enumerate(out)
                if isinstance(t, torch.Tensor) and id(t) in self._where}
        if not todo:
            return tree
        place = self.place
        cur = {i: out[i] for i in todo}
        track = torch.is_grad_enabled() and self.grad
        by_entry: Dict[tuple, List[int]] = {}       # over the batch axes
        for i, (k, _, _) in todo.items():
            b = self.plans[k].batch
            if b is not None and place._group(b[1]).world_size > 1:
                by_entry.setdefault(_entry_axes(b[1]), []).append(i)
        for E, idxs in by_entry.items():
            g = place._group(E)
            pieces = []
            for i in idxs:
                k, _, owned = todo[i]
                plan = self.plans[k]
                if plan.batch[0] < plan.lead and not owned:
                    shape = place.block_shape(k, place.spec[k])[plan.lead:]
                    pieces.append(torch.zeros(
                        shape, dtype=out[i].dtype, device=out[i].device,
                        requires_grad=track))
                else:
                    pieces.append(out[i])
            dims = [None if d < p.lead else d - p.lead for d, p in (
                (self.plans[todo[i][0]].batch[0], self.plans[todo[i][0]])
                for i in idxs)]
            got = g.gather_blocks(pieces, dims, [
                bool(self.S) and set(E) <= set(self.S)] * len(idxs))
            for i, t, d in zip(idxs, got, dims):
                k, mi, _ = todo[i]
                if d is None:                       # the owner's row
                    dim = self.plans[k].batch[0]
                    size = place.index_of[k].shape[dim]
                    t = t[mi[dim] // (size // g.world_size)].clone()
                cur[i] = t
        row = place._group("model")
        idxs = [i for i, (k, _, _) in todo.items()
                if self.plans[k].model is not None]
        if idxs and row.world_size > 1:              # over the row
            plans = [self.plans[todo[i][0]] for i in idxs]
            got = row.gather_blocks([cur[i] for i in idxs],
                                    [p.model - p.lead for p in plans],
                                    [p.model_sum for p in plans])
            cur.update(zip(idxs, got))
        for i, (k, _, _) in todo.items():
            plan = self.plans[k]
            if plan.ranges is not None:              # the rank's ranges
                dim = plan.tp_dim - plan.lead
                cur[i] = torch.cat([cur[i].narrow(dim, lo, hi - lo)
                                    for lo, hi in plan.ranges], dim=dim)
            out[i] = cur[i]
        return tree_unflatten_like(tree, out)

    def block_grads(self, grads: List[torch.Tensor], dtype=torch.float32
                    ) -> Dict[str, torch.Tensor]:
        """The gradients of ``tree``'s leaves (in ``tree_leaves`` order) →
        each key's param-spec block of them, in ``dtype``."""
        out = {}
        place = self.place
        for k in place.keys:
            slots = self.slots[k]
            if self.plans[k].lead == 0:
                out[k] = grads[slots[0][0]].to(dtype)
                continue
            g0 = grads[slots[0][0]]
            t = torch.empty(place.block_shape(k, place.spec[k]), dtype=dtype,
                            device=g0.device)
            for pos, local in slots:
                t[local].copy_(grads[pos])
            out[k] = t
        return out
