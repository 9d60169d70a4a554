"""AdamW (+ cosine schedule, global-norm clipping) on the port's parameter
trees.

Port of ``repro.train.optimizer``: the state mirrors the params (m and v,
f32 by default, ``moment_dtype`` to store them narrower), the update math
runs in f32 and casts back to each leaf's dtype, and the schedule is the
JAX package's, in f32.  The functions are pure: they return new params and
a new state and leave their inputs as they were.

Decoupled weight decay follows the JAX package's rule, which decays a leaf
of ``ndim >= 2`` in *its* layout.  The JAX package stacks each layer stack
on leading axes (``transformer._stack``), so every per-layer leaf is
decayed there, norm scales included; the port keeps the layers as lists
(``repro_torch.models.bridge``), where a layer's norm scale is 1-D.
``decay_mask(params, cfg)`` therefore counts the stack's axes back in: a
leaf decays when its ndim plus the axes the JAX package stacks it on is at
least 2.  ``adamw_update`` takes that mask as its one decay rule.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.utils.tree import (tree_leaves, tree_map,
                                    tree_unflatten_like)


class AdamWState(NamedTuple):
    step: torch.Tensor         # scalar int32
    m: Any                     # first moment  (f32 tree)
    v: Any                     # second moment (f32 tree)


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def adamw_init(params, moment_dtype: torch.dtype = torch.float32
               ) -> AdamWState:
    """``moment_dtype=torch.bfloat16`` halves the optimizer's memory (the
    update math still runs in f32)."""
    def zeros(t):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                              device=p.device), t)
    step_dev = next((p.device for p in tree_leaves(params)), None)
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=step_dev),
                      m=zeros(params), v=zeros(params))


def schedule(step, cfg: OptConfig) -> torch.Tensor:
    """Linear warm-up to ``lr``, then a cosine to ``min_lr_frac · lr``
    (f32, as the JAX package computes it)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(torch.tensor(math.pi, dtype=torch.float32,
                                            device=s.device) * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in leaves))


def _stack_axes(cfg) -> dict:
    """Top-level key → the axes the JAX package stacks a leaf of that
    stack on, and the inner stacks' keys, which add one more."""
    from repro_torch.models.transformer import layer_stacks
    return {st.name: (st.lead, dict(st.inner)) for st in layer_stacks(cfg)}


def decay_mask(params, cfg) -> Any:
    """A tree of bools in ``params``' structure: True where the JAX
    package's AdamW decays the leaf (its ndim in the JAX layout, stack axes
    included, at least 2)."""
    stacks = _stack_axes(cfg)

    def rule(extra):
        return lambda p: p.ndim + extra >= 2

    out = {}
    for key, sub in params.items():
        if key not in stacks:
            out[key] = tree_map(rule(0), sub)
            continue
        lead, inner = stacks[key]
        out[key] = [{k: tree_map(rule(lead + (1 if k in inner else 0)), v)
                     for k, v in layer.items()} for layer in sub]
    return out


def adamw_update(grads, state: AdamWState, params, cfg: OptConfig, decay,
                 gnorm: Optional[torch.Tensor] = None):
    """Returns (new_params, new_state, metrics).  ``decay``: a tree of
    bools in ``params``' structure (``decay_mask``).  ``gnorm``: the norm
    of the whole gradient where ``grads`` holds only this rank's shards of
    it (``Placement.global_norm``: the squared norms of every shard summed
    over the mesh before the square root); by default ``global_norm(grads)``.
    The update is elementwise, so a shard of the state updates as the
    same elements of the whole would."""
    step = state.step + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(step, cfg)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.tensor(cfg.b1, dtype=torch.float32,
                           device=stepf.device) ** stepf
    bc2 = 1 - torch.tensor(cfg.b2, dtype=torch.float32,
                           device=stepf.device) ** stepf
    flat_p = tree_leaves(params)
    flat_g, flat_m, flat_v = (tree_leaves(t) for t in (grads, state.m,
                                                       state.v))
    flat_d = tree_leaves(decay)
    new_p, new_m, new_v = [], [], []
    with torch.no_grad():
        for g, m, v, p, dec in zip(flat_g, flat_m, flat_v, flat_p, flat_d):
            g = g.float() * scale
            m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
            v32 = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g)
            delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
            if dec:               # decoupled decay (the JAX layout's rule)
                delta = delta + cfg.weight_decay * p.float()
            new_p.append((p.float() - lr * delta).to(p.dtype))
            new_m.append(m32.to(m.dtype))
            new_v.append(v32.to(v.dtype))
    return (tree_unflatten_like(params, new_p),
            AdamWState(step, tree_unflatten_like(state.m, new_m),
                       tree_unflatten_like(state.v, new_v)),
            {"grad_norm": gnorm, "lr": lr})
