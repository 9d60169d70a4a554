"""First-class hardware descriptions for the profiling subsystem.

The paper's profile-don't-estimate doctrine only works if a performance map
says *what it was profiled on*.  ``HardwareProfile`` (the compute device) and
``LinkProfile`` (the interconnect) carry exactly the constants the edge cost
model consumes, are serialized into the performance map (schema v2, see
``repro_torch.core.perfmap``), and round-trip through ``to_dict``/``from_dict``
with strict validation so a corrupt map fails loudly instead of silently
profiling the wrong machine.

Presets:

* ``JETSON_ORIN_NANO`` + ``WIFI_GLOO`` — the paper's 2-board prototype
  (identical to the historic ``EdgeConstants`` defaults).
* ``TPU_V5E`` + ``TPU_ICI`` — a coarse roofline preset from the §Roofline
  constants (197 TFLOP/s bf16, 819 GB/s HBM, 50 GB/s ICI per link), kept
  so that a map profiled by the JAX package still loads.
* ``H100_SXM`` + ``H100_GLOO_STAGED`` — the card the port runs on and its
  gloo link staged through host memory, fitted on it by ``chip_smoke.py``
  (the ``[fit]`` lines; each description names the run).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.costmodel import (TPU_HBM_BW, TPU_HBM_GB, TPU_ICI_BW,
                                  TPU_PEAK_FLOPS, EdgeConstants)

_STR_FIELDS = ("name", "description")


def _validated_kwargs(cls, d, kind: str) -> Dict:
    """Shared strict decoder for both profile dataclasses."""
    if not isinstance(d, dict):
        raise ValueError(f"{kind} must be a JSON object, got "
                         f"{type(d).__name__}")
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"{kind} has unknown fields {unknown}")
    if "name" not in d:
        raise ValueError(f"{kind} is missing the required 'name' field")
    for k, v in d.items():
        if k in _STR_FIELDS:
            if not isinstance(v, str):
                raise ValueError(f"{kind} field {k!r} must be a string, "
                                 f"got {v!r}")
        elif isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ValueError(f"{kind} field {k!r} must be a number, "
                             f"got {v!r}")
    return d


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    """One compute device: effective-FLOP/s curve, overheads, power draw.

    ``eff_inf``/``eff_slope`` parameterize the occupancy curve
    ``eff(B) = eff_inf - eff_slope/B`` the edge simulator uses; the memory
    fields (``mem_bw_bytes``/``mem_gb``) only matter for roofline-style
    presets and default to 0 (unknown).
    """
    name: str
    peak_flops: float = 1.28e12          # spec-sheet peak (documentation)
    eff_inf: float = 0.62e12             # saturated effective FLOP/s
    eff_slope: float = 0.19e12           # occupancy ramp
    launch_overhead_ms: float = 6.0      # per-inference fixed cost
    coord_overhead_ms: float = 30.0      # master-worker partition/assemble
    voltage_eff_penalty: float = 0.70    # staging copies pollute occupancy
    power_active_w: float = 5.8          # incremental board power, computing
    power_comm_w: float = 0.25           # incremental during staging/wire
    mem_bw_bytes: float = 0.0            # HBM/LPDDR bandwidth (roofline)
    mem_gb: float = 0.0
    description: str = ""

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d) -> "HardwareProfile":
        return HardwareProfile(
            **_validated_kwargs(HardwareProfile, d, "hardware profile"))


@dataclasses.dataclass(frozen=True)
class LinkProfile:
    """One interconnect: host-staging curve + wire RTT + sync overhead."""
    name: str
    staging_bw_base: float = 100e6       # pinned-copy floor, bytes/s
    staging_bw_extra: float = 410e6      # DMA amortization headroom
    staging_knee_bytes: float = 5e6
    staging_fixed_ms: float = 1.6        # per collective call
    wire_rtt_ms: float = 1.0             # per collective round
    sync_overhead_ms: float = 4.0        # barrier/straggler per block set
    description: str = ""

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d) -> "LinkProfile":
        return LinkProfile(**_validated_kwargs(LinkProfile, d,
                                               "link profile"))


def to_edge_constants(hw: HardwareProfile,
                      link: Optional[LinkProfile] = None) -> EdgeConstants:
    """Combine a device + link profile into the simulator's constant block."""
    link = link or WIFI_GLOO
    return EdgeConstants(
        eff_inf=hw.eff_inf, eff_slope=hw.eff_slope,
        launch_overhead_ms=hw.launch_overhead_ms,
        coord_overhead_ms=hw.coord_overhead_ms,
        voltage_eff_penalty=hw.voltage_eff_penalty,
        staging_bw_base=link.staging_bw_base,
        staging_bw_extra=link.staging_bw_extra,
        staging_knee_bytes=link.staging_knee_bytes,
        staging_fixed_ms=link.staging_fixed_ms,
        wire_rtt_ms=link.wire_rtt_ms,
        power_active_w=hw.power_active_w, power_comm_w=hw.power_comm_w,
        sync_overhead_ms=link.sync_overhead_ms)


# --- presets ---------------------------------------------------------------

JETSON_ORIN_NANO = HardwareProfile(
    name="jetson-orin-nano",
    description="Jetson Orin Nano 8 GB, 15 W mode (paper prototype; "
                "DESIGN.md §6 calibration)")

WIFI_GLOO = LinkProfile(
    name="wifi-gloo",
    description="GLOO over WiFi: GPU→CPU→GPU staging + 200-900 Mbps wire")

TPU_V5E = HardwareProfile(
    name="tpu-v5e",
    peak_flops=TPU_PEAK_FLOPS,
    # coarse roofline calibration: large-batch kernels reach ~55 % of peak,
    # small batches ramp like the edge curve scaled by the peak ratio
    eff_inf=0.55 * TPU_PEAK_FLOPS,
    eff_slope=0.15 * TPU_PEAK_FLOPS,
    launch_overhead_ms=0.05, coord_overhead_ms=0.5,
    voltage_eff_penalty=1.0,             # no host staging on ICI
    power_active_w=170.0, power_comm_w=40.0,
    mem_bw_bytes=TPU_HBM_BW, mem_gb=TPU_HBM_GB,
    description="TPU v5e roofline preset (197 TFLOP/s bf16, 819 GB/s HBM)")

TPU_ICI = LinkProfile(
    name="tpu-ici",
    staging_bw_base=TPU_ICI_BW, staging_bw_extra=0.0,
    staging_knee_bytes=1.0, staging_fixed_ms=0.005,
    wire_rtt_ms=0.001, sync_overhead_ms=0.05,
    description="2D-ring ICI, 50 GB/s per link; no host staging hop")

# NVIDIA's data sheet, H100 SXM, dense bf16 without sparsity, at 700 W
H100_PEAK_FLOPS = 989e12
H100_HBM_BW = 3.35e12                     # bytes/s
H100_HBM_GB = 80.0

H100_SXM = HardwareProfile(
    name="h100-sxm",
    peak_flops=H100_PEAK_FLOPS, mem_bw_bytes=H100_HBM_BW,
    mem_gb=H100_HBM_GB,                  # published (data sheet)
    # fitted: eff(B) = eff_inf - eff_slope/B and the per-forward fixed cost,
    # to the `local` forward curve of llama3.2-1b at full width (bf16, 32
    # tokens, batches 1-32) that the measured backend times; the FLOPs are
    # the cost model's count (`vit_flops_per_sample`), not achieved FLOP/s;
    # bounded so that 0 < eff(B) <= peak_flops at every swept batch
    eff_inf=3.323e14, eff_slope=2.659e14, launch_overhead_ms=18.214,
    # fitted: a `prism` ViT-B/16 forward's wall, less its staged
    # collectives, less the `local` forward over P
    coord_overhead_ms=10.70,
    voltage_eff_penalty=1.0,             # not fitted: no penalty assumed
    # measured: nvidia-smi power.draw during that sweep less the idle draw;
    # staging leaves the card idle, so it adds no draw (not measured)
    power_active_w=31.2, power_comm_w=0.0,
    description="NVIDIA H100 80GB HBM3 (SXM) at a 700 W power limit; "
                "eff_inf, eff_slope, launch_overhead_ms, coord_overhead_ms "
                "and power_active_w fitted by the chip_smoke.py run of "
                "2026-10-17 ([fit] lines); peak_flops, mem_bw_bytes and "
                "mem_gb from NVIDIA's data sheet")

H100_GLOO_STAGED = LinkProfile(
    name="h100-gloo-staged",
    # fitted from the ViT-B/16 `voltage` and `prism` forwards on 2 ranks
    # sharing the card: per forward, staged-collective ms = calls ·
    # staging_fixed_ms + 2 · received bytes / staging_bw_base (the cost
    # model stages every received byte twice, device → host → device)
    staging_bw_base=1547.1e6, staging_bw_extra=0.0, staging_knee_bytes=1.0,
    staging_fixed_ms=1.146,
    # one host: the gloo hop over loopback and the ranks' wait are inside
    # the staged-collective time above
    wire_rtt_ms=0.0, sync_overhead_ms=0.0,
    description="gloo between 2 ranks on one NVIDIA H100 80GB HBM3 at a "
                "700 W power limit, staged device -> pinned host -> device;"
                " staging_fixed_ms and staging_bw_base fitted by the "
                "chip_smoke.py run of 2026-10-17 ([fit] line of [vit])")

PRESET_HARDWARE = {p.name: p for p in (JETSON_ORIN_NANO, TPU_V5E, H100_SXM)}
PRESET_LINKS = {p.name: p for p in (WIFI_GLOO, TPU_ICI, H100_GLOO_STAGED)}
