"""Carry the JAX package's parameters into the port.

``params_from_numpy`` takes the JAX params tree as numpy arrays
(``jax.tree.map(np.asarray, registry.init_params(cfg))``) and returns the
port's parameter dict: the leading layer axis of every stack of
``transformer.layer_stacks`` (the JAX package's stacked scan layout:
``layers``, gemma2's ``local_layers`` and ``global_layers``, the moe
family's ``first_layers``, whisper's ``enc_layers`` and ``dec_layers``,
the vlm's ``cross_layers``, hymba's ``layers``, xLSTM's ``groups``) is
unstacked into a list of per-layer dicts; the vlm's doubly stacked
``self_layers`` (``[n_groups, k_every − 1, ...]``) becomes one list,
group by group, and a stack's inner stacks (``Stack.inner``: xLSTM's
``mlstm`` and ``m_ln``, ``[groups, slstm_every − 1, ...]``) become a list
inside each layer.  Every leaf becomes a tensor on ``device`` with its
dtype kept (the vlm's ``gate`` an f32 scalar); a None leaf (hymba's
``fuse`` where ``n_heads·hd == d``) stays None.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.transformer import layer_stacks


def tensor_from_numpy(a: np.ndarray, device="cpu") -> torch.Tensor:
    """numpy → torch, bit for bit.  ml_dtypes bfloat16 (which
    ``torch.from_numpy`` rejects) goes through its 16-bit pattern."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _convert(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_convert(v, device) for v in tree]
    if tree is None:
        return None
    return tensor_from_numpy(tree, device)


def _unstack(tree: Any, i: int, lead: int) -> Any:
    """Layer ``i`` of a stack whose leaves hold the layers on their first
    ``lead`` axes (2: groups of layers), in walk order."""
    if isinstance(tree, dict):
        return {k: _unstack(v, i, lead) for k, v in tree.items()}
    if tree is None:
        return None
    a = np.asarray(tree)
    return a.reshape((-1,) + a.shape[lead:])[i]


def _layer(stacked: Any, i: int, lead: int, inner: dict) -> Any:
    """Layer ``i`` of a stack, its inner stacks unstacked into lists."""
    layer = _unstack(stacked, i, lead)
    for key, depth in inner.items():
        layer[key] = [_unstack(layer[key], j, 1) for j in range(depth)]
    return layer


def params_from_numpy(np_params: dict, cfg, device="cpu") -> dict:
    """JAX params tree (numpy leaves) → the port's params for ``cfg``."""
    stacks = {st.name: st for st in layer_stacks(cfg)}
    out = {k: _convert(v, device) for k, v in np_params.items()
           if k not in stacks}
    for name, st in stacks.items():
        out[name] = [_convert(_layer(np_params[name], i, st.lead, st.inner),
                              device) for i in range(st.depth)]
    return out
