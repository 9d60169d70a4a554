"""Sweep grids for the offline profiling pass (paper §3.3, Fig. 2).

``SweepSpec`` is shared by every backend; the ``PAPER_*`` grids reproduce
the paper's batch × compression × bandwidth sweep.  ``workload_from_config``
derives the analytic workload description (used for the modeled staging/wire
terms) from a deployed model config instead of the hard-coded ViT-base.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.costmodel import EdgeWorkload

PAPER_BATCHES = (1, 2, 4, 8, 16, 32)
PAPER_CRS = (3.3, 4.95, 9.9)
PAPER_BWS = (200, 300, 400, 500, 600, 700, 800, 900)

# token-model sequence length the measured backend profiles at when the
# session does not say otherwise (ViT's length is fixed by its patch grid)
DEFAULT_SEQ_LEN = 32
VIT_SEQ_LEN = 197


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    batches: Sequence[int] = PAPER_BATCHES
    crs: Sequence[float] = PAPER_CRS
    bandwidths_mbps: Sequence[float] = PAPER_BWS
    P: int = 2
    warmup_runs: int = 20          # T in the paper's cost estimate
    # extra exchange codecs to sweep alongside the segment-means CR grid:
    # each entry is a codec name ("int8") or a (name, param) pair
    # (("topk", 8)); "segment_means" itself is the `crs` axis above
    codecs: Sequence = ()


def codec_entries(spec: SweepSpec):
    """Normalized (name, param) pairs of the spec's extra codec axis
    (``segment_means`` is skipped — it is the classic ``crs`` grid)."""
    out = []
    for c in spec.codecs:
        name, param = c if isinstance(c, (tuple, list)) else (c, 0)
        if name == "segment_means":
            continue
        if param == 0:
            from repro_torch.transport import get_codec
            param = get_codec(name).default_param
        out.append((name, int(param)))
    return out


def sweep_cost(spec: SweepSpec) -> int:
    """|B|·(|CR|+|codecs|)·|BW|·T inference passes (the paper's one-time
    profiling cost, extended by the codec axis)."""
    return (len(spec.batches)
            * (len(spec.crs) + len(codec_entries(spec)))
            * len(spec.bandwidths_mbps) * spec.warmup_runs)


def workload_from_config(cfg, seq_len: int = 0) -> EdgeWorkload:
    """Analytic per-sample workload of the *deployed* config — layer count,
    widths, and element size come from the model, not from ViT-base."""
    n_tokens = seq_len or (VIT_SEQ_LEN if cfg.family == "vit"
                           else DEFAULT_SEQ_LEN)
    return EdgeWorkload(n_layers=cfg.n_layers, d_model=cfg.d_model,
                        d_ff=cfg.d_ff, n_tokens=n_tokens,
                        bytes_per_el=cfg.torch_dtype.itemsize)
