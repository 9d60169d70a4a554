"""Offline profiling sweep (paper §3.3, Fig. 2) — back-compat surface.

Port of ``repro.core.profiler``.  The canonical implementation lives in
:mod:`repro_torch.profiling` (``ProfileBackend`` registry: ``simulated`` /
``measured`` / ``trace``); this module re-exports the sweep grids and keeps
the two historic free functions:

* :func:`profile_simulated` — thin wrapper over the ``simulated`` backend.
* :func:`profile_measured` — **deprecated** shim forwarding to the
  ``measured`` backend on a fresh full-width ``vit-base-16`` session, on
  the card unless ``device="cpu"`` is passed.  Profile through
  ``InferenceSession.profile(backend="measured")`` to measure the
  session's own config and registered plan executables.
"""
from __future__ import annotations

import warnings
from typing import Optional

from repro_torch.core.costmodel import EdgeCostModel
from repro_torch.core.perfmap import PerfMap
from repro_torch.profiling.sweep import (PAPER_BATCHES, PAPER_BWS, PAPER_CRS,
                                         SweepSpec, sweep_cost)

__all__ = ["PAPER_BATCHES", "PAPER_CRS", "PAPER_BWS", "SweepSpec",
           "sweep_cost", "profile_simulated", "profile_measured"]


def profile_simulated(model: Optional[EdgeCostModel] = None,
                      spec: SweepSpec = SweepSpec()) -> PerfMap:
    from repro_torch.profiling.backends import ProfileContext, get_backend
    return get_backend("simulated").profile(ProfileContext(), spec,
                                            model=model)


def profile_measured(spec: SweepSpec = SweepSpec(), iters: int = 3,
                     device="cuda", **legacy) -> PerfMap:
    """Deprecated: measure through the ``measured`` backend on a fresh
    ``vit-base-16`` session (the historic hard-coded behaviour)."""
    warnings.warn(
        "profile_measured is deprecated; use InferenceSession.profile("
        "backend='measured') to profile the session's own config and plans",
        DeprecationWarning, stacklevel=2)
    unknown = set(legacy) - {"n_layers"}
    if unknown:
        raise TypeError(f"profile_measured got unexpected keyword arguments "
                        f"{sorted(unknown)}")
    if "n_layers" in legacy:
        warnings.warn("profile_measured(n_layers=...) was never used and has "
                      "been removed; the value is ignored",
                      DeprecationWarning, stacklevel=2)
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.core.segment_means import cr_to_L
    from repro_torch.profiling.sweep import VIT_SEQ_LEN
    plans = [ExecutionPlan.local()]
    for cr in spec.crs:
        plans.append(ExecutionPlan.prism_sim(
            L=cr_to_L(VIT_SEQ_LEN, spec.P, cr), cr=cr,
            seq_shards=spec.P))
    session = InferenceSession.from_config("vit-base-16", reduced=False,
                                           plans=plans, device=device)
    return session.profile(spec, backend="measured", iters=iters)
