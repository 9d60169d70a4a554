"""Small tree helpers for the port's parameter trees (nested dicts, lists,
tuples and NamedTuples of tensors; a None is an empty subtree, as in JAX).

The traversals that JAX's ``tree_util`` gives the JAX package:
``tree_map`` over several trees of one structure, ``tree_leaves``,
``tree_leaves_with_paths`` (each leaf's key path, as the checkpoint
manager of either package joins it with ``/``) and
``tree_unflatten_like``; and ``repro.utils.tree``'s ``param_count``,
``param_bytes``, ``tree_norm``, ``tree_zeros_like``, ``tree_add`` and
``tree_scale``.
Dict keys are visited in sorted order, as ``jax.tree_util`` flattens
them.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


def _is_namedtuple(t: Any) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees in ``rest``
    (each of ``tree``'s structure); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, t, *(r[i] for r in rest))
                            for i, t in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves_with_paths(tree: Any, prefix: Tuple = ()
                           ) -> List[Tuple[Tuple, Any]]:
    """(key path, leaf) in ``jax.tree_util`` order: dict keys sorted, a
    sequence by index, a NamedTuple by field (its path element
    ``".name"``, as JAX's ``GetAttrKey`` prints)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_leaves_with_paths(tree[k], prefix + (k,))]
    if _is_namedtuple(tree):
        return [kv for name, t in zip(tree._fields, tree)
                for kv in tree_leaves_with_paths(t, prefix + (f".{name}",))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree)
                for kv in tree_leaves_with_paths(t, prefix + (i,))]
    return [(prefix, tree)]


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in tree_leaves_with_paths(tree)]


def tree_unflatten_like(tree: Any, leaves: List[Any]) -> Any:
    """``tree``'s structure with its leaves replaced, in
    ``tree_leaves`` order, by ``leaves``."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: None for k in t}
            for k in sorted(t):
                out[k] = build(t[k])
            return out
        if _is_namedtuple(t):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)
    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def param_count(tree) -> int:
    """Total number of scalar parameters in a tree."""
    return int(sum(t.numel() for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor)))


def param_bytes(tree) -> int:
    """Total bytes of the tensors in a tree (meta tensors count at their
    shapes and dtypes, as the JAX package's ``ShapeDtypeStruct`` leaves
    do)."""
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor)))


def tree_norm(tree) -> torch.Tensor:
    """Global L2 norm over every leaf of a tree (f32, each leaf's sum of
    squares first)."""
    sums = [torch.sum(torch.square(t.float())) for t in tree_leaves(tree)]
    return torch.sqrt(sum(sums))


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)
