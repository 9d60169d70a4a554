"""Carry the JAX package's parameters into the port.

``params_from_numpy`` takes the JAX params tree as numpy arrays
(``jax.tree.map(np.asarray, registry.init_params(cfg))``) and returns the
port's parameter dict: the leading layer axis of ``params["layers"]`` (the
JAX package's stacked scan layout) is unstacked into a list of per-layer
dicts, and every leaf becomes a tensor on ``device`` with its dtype kept.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


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
    return tensor_from_numpy(tree, device)


def _unstack(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def params_from_numpy(np_params: dict, cfg, device="cpu") -> dict:
    """JAX params tree (numpy leaves) → the port's params for ``cfg``."""
    out = {k: _convert(v, device) for k, v in np_params.items()
           if k != "layers"}
    stacked = np_params["layers"]
    out["layers"] = [_convert(_unstack(stacked, i), device)
                     for i in range(cfg.n_layers)]
    return out
