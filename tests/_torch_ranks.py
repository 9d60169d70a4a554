"""Rank bodies for the port's multi-rank CPU tests.

``repro_torch.core.seq_group.spawn`` runs each of these in fresh processes
that import them by name, so they live in a module of their own that
imports neither JAX nor the JAX package (a rank starts faster without
them).  Inputs arrive as numpy arrays; results go back as numpy arrays.
"""
import numpy as np
import torch

from repro_torch.core.exchange import (ExchangeConfig, ExchangeMode,
                                       exchange_attention)
from repro_torch.core.seq_group import get_seq_group


def _part(a, rank, world):
    n = a.shape[1] // world
    return torch.from_numpy(np.ascontiguousarray(a[:, rank * n:(rank + 1) * n]))


def exchange_cases(rank, world, cases):
    """Each case: global q/k/v (and kv_mask) plus exchange settings; this
    rank runs ``exchange_attention`` on its partition → list of outputs,
    and the bytes its gathers received."""
    outs = []
    for c in cases:
        xcfg = ExchangeConfig(ExchangeMode(c["mode"]), seq_axis="seq",
                              seq_shards=world,
                              L=c.get("L", 0))
        mask = c.get("kv_mask")
        out = exchange_attention(
            _part(c["q"], rank, world), _part(c["k"], rank, world),
            _part(c["v"], rank, world), xcfg, causal=c["causal"],
            logit_softcap=c.get("softcap"),
            kv_mask=None if mask is None else _part(mask, rank, world))
        outs.append(out.numpy())
    return outs, get_seq_group("seq").stats.payload_bytes


def vit_logits(rank, world, np_params, reduced, images, plans, dispatch_bw):
    """Reduced ViT in the port from the JAX weights: logits of ``images``
    under each plan key in ``plans`` (built with P = world), and the plan
    ``dispatch`` picks after this rank observed ``dispatch_bw[rank]``."""
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.configs import get_config
    from repro_torch.models.bridge import params_from_numpy
    cfg = get_config("vit-base-16").reduced(**reduced)
    made = {"local": ExecutionPlan.local(),
            "voltage": ExecutionPlan.voltage(seq_shards=world)}
    for key in plans:
        if key.startswith("prism"):
            L = int(key.split(":")[1])
            made[key] = ExecutionPlan.prism(L=L, cr=197 / (L * world),
                                            seq_shards=world)
    session = InferenceSession.from_config(
        "vit-base-16", plans=[made[k] for k in plans], reduced=reduced,
        params=params_from_numpy(np_params, cfg), device="cpu",
        initial_bandwidth_mbps=dispatch_bw[rank])
    batch = {"images": torch.from_numpy(images)}
    logits = {k: session.run(made[k].key, batch).numpy() for k in plans}
    session.profile(backend="simulated")
    session.dispatch(batch)
    rec = session.history[-1]
    return logits, rec.exec_key, rec.decision.mode, session.bandwidth
