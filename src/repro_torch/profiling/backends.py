"""Pluggable profiling backends (paper §3.3 made first-class).

A backend turns a :class:`ProfileContext` (what is deployed: config, params,
registered plan executables, hardware/link profiles) plus a
:class:`~repro_torch.profiling.sweep.SweepSpec` (what to sweep) into a
:class:`~repro_torch.core.perfmap.PerfMap` stamped with the hardware it describes.

Built-ins:

* ``simulated`` — the edge cost model; reproduces the paper's sweep
  instantly.  Defaults to the paper's ViT-base workload on the Jetson/WiFi
  preset (so the published crossovers reproduce), overridable with any
  ``HardwareProfile``/``LinkProfile``/``EdgeWorkload``.
* ``measured`` — registered, but raises ``NotImplementedError`` until the
  CUDA-event timing of the session's executables is ported.
* ``trace`` — replays a previously saved performance-map artifact
  (``path=``) or adopts an in-memory map (``perfmap=``) — the
  "profile once per fleet, ship the JSON" deployment story.

Register your own with ``@register_backend`` — anything with a ``name`` and
a ``profile(ctx, spec, **opts)`` returning a PerfMap plugs into
``InferenceSession.profile(backend=...)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Type

from repro_torch.core.costmodel import EdgeCostModel, EdgeWorkload
from repro_torch.core.perfmap import PerfEntry, PerfKey, PerfMap
from repro_torch.profiling.hardware import (JETSON_ORIN_NANO, WIFI_GLOO,
                                      HardwareProfile, LinkProfile,
                                      to_edge_constants)
from repro_torch.profiling.sweep import (SweepSpec, codec_entries,
                                   workload_from_config)


def _codec_row(model: EdgeCostModel, ctx: "ProfileContext", name: str,
               param: int, B: int, bw: float, P: int,
               link_kind: str) -> Tuple[Dict, Dict]:
    """One simulated (codec, batch, bandwidth) cell: per-device compute
    over the full reconstructed context + transport accounting from the
    codec × link pair (``repro_torch.transport.exchange_cost``)."""
    from repro_torch.core.costmodel import vit_flops_per_sample
    from repro_torch.transport import exchange_cost
    w, c = model.w, model.c
    N = w.n_tokens
    Np = N // P + (N % P > 0)
    terms = exchange_cost(name, n_tokens=N, d_model=w.d_model,
                          bytes_per_el=w.bytes_per_el, batch=B, P=P,
                          n_layers=w.n_layers, bandwidth_mbps=bw,
                          profile=ctx.link, link=link_kind, param=param)
    # remote partitions are reconstructed per token, so attention runs over
    # the full context (vs PRISM's Np + (P-1)·L); decode is charged to the
    # compute stage of the receiving device
    flops = vit_flops_per_sample(w, Np, N)
    b_eff = B * Np / N
    compute_ms = (flops * B / c.eff(b_eff) * 1e3 + c.launch_overhead_ms
                  + c.coord_overhead_ms + terms["decode_ms"])
    row = model.pack(B, compute_ms, terms["staging_ms"], terms["comm_ms"],
                     boards=P)
    return row, terms


@dataclasses.dataclass
class ProfileContext:
    """Everything a backend may need about the deployed session.

    All fields optional: the simulated backend runs from an empty context;
    the measured backend requires ``cfg`` + ``execs`` (an
    ``InferenceSession`` provides them via ``session.profile_context()``).
    """
    cfg: Any = None
    params: Any = None
    plans: Dict[str, Any] = dataclasses.field(default_factory=dict)
    execs: Dict[str, Callable] = dataclasses.field(default_factory=dict)
    hardware: HardwareProfile = JETSON_ORIN_NANO
    link: LinkProfile = WIFI_GLOO
    workload: Optional[EdgeWorkload] = None   # analytic workload override
    cost_model: Optional[EdgeCostModel] = None  # full simulator override
    seq_len: int = 0                          # token-model profiling length

    def edge_model(self, workload: Optional[EdgeWorkload] = None
                   ) -> EdgeCostModel:
        if self.cost_model is not None:
            return self.cost_model
        w = workload or self.workload or EdgeWorkload()
        return EdgeCostModel(to_edge_constants(self.hardware, self.link), w)


class ProfileBackend:
    """Protocol: subclass, set ``name``, implement ``profile``."""

    name = ""

    def profile(self, ctx: ProfileContext, spec: SweepSpec = SweepSpec(),
                **opts) -> PerfMap:
        raise NotImplementedError


_REGISTRY: Dict[str, ProfileBackend] = {}


def register_backend(cls: Type[ProfileBackend]) -> Type[ProfileBackend]:
    """Class decorator: instantiate and register under ``cls.name``."""
    name = getattr(cls, "name", "")
    if not name:
        raise ValueError("profile backend must define a non-empty `name`")
    if name in _REGISTRY:
        raise ValueError(f"profile backend {name!r} already registered")
    _REGISTRY[name] = cls()
    return cls


def get_backend(name: str) -> ProfileBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown profile backend {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def list_backends():
    return sorted(_REGISTRY)


def _entry(r: Dict, meta: Optional[Dict] = None) -> PerfEntry:
    return PerfEntry(total_ms=r["total_ms"], per_sample_ms=r["per_sample_ms"],
                     per_sample_j=r["per_sample_j"],
                     compute_ms=r["compute_ms"], staging_ms=r["staging_ms"],
                     comm_ms=r["comm_ms"], meta=meta or {})


def _stamp(pm: PerfMap, ctx: ProfileContext,
           from_profiles: bool = True) -> PerfMap:
    """Embed provenance (schema v2) — only when the entries really came
    from the context's hardware/link profiles.  A caller-supplied
    ``EdgeCostModel`` has unknown provenance; stamping the preset names on
    its output would make the map lie about what it was profiled on."""
    if from_profiles:
        pm.hardware, pm.link = ctx.hardware, ctx.link
    return pm


# --------------------------------------------------------------------------
# simulated
# --------------------------------------------------------------------------

@register_backend
class SimulatedBackend(ProfileBackend):
    """Cost-model sweep — the paper's offline profiling pass, instant."""

    name = "simulated"

    def profile(self, ctx: Optional[ProfileContext] = None,
                spec: SweepSpec = SweepSpec(), *,
                model: Optional[EdgeCostModel] = None,
                link_kind: str = "staged") -> PerfMap:
        from repro_torch.core.segment_means import cr_to_L
        from repro_torch.transport import exchange_wire_bytes
        ctx = ctx or ProfileContext()
        custom_model = model is not None or ctx.cost_model is not None
        model = model or ctx.edge_model()
        pm = PerfMap()
        w = model.w
        N = w.n_tokens
        codecs = codec_entries(spec)
        for B in spec.batches:
            pm.put(PerfKey("local", B, 0.0, 0.0), _entry(model.local(B)))
            for bw in spec.bandwidths_mbps:
                rv = model.distributed(B, bw, spec.P, L=None)
                wb_v = exchange_wire_bytes(
                    "identity", n_tokens=N, d_model=w.d_model,
                    bytes_per_el=w.bytes_per_el, batch=B, P=spec.P,
                    n_layers=w.n_layers)
                pm.put(PerfKey("voltage", B, 0.0, bw),
                       _entry(rv, {"wire_bytes": wb_v}))
                for cr in spec.crs:
                    L = cr_to_L(N, spec.P, cr)
                    rp = model.distributed(B, bw, spec.P, L=L)
                    wb = exchange_wire_bytes(
                        "segment_means", n_tokens=N, d_model=w.d_model,
                        bytes_per_el=w.bytes_per_el, batch=B, P=spec.P,
                        n_layers=w.n_layers, L=L)
                    pm.put(PerfKey("prism", B, cr, bw),
                           _entry(rp, {"L": L, "wire_bytes": wb}))
                for name, param in codecs:
                    row, terms = _codec_row(model, ctx, name, param, B, bw,
                                            spec.P, link_kind)
                    pm.put(PerfKey("prism", B, round(terms["ratio"], 2),
                                   bw, name),
                           _entry(row, {"codec": name, "param": param,
                                        "wire_bytes": terms["wire_bytes"]}))
        return _stamp(pm, ctx, from_profiles=not custom_model)


# --------------------------------------------------------------------------
# measured
# --------------------------------------------------------------------------

@register_backend
class MeasuredBackend(ProfileBackend):
    """Times the session's registered plan executables on the card.

    Registered so the backend names match the JAX package's, but not built
    yet: timing the torch executables with CUDA events is ROADMAP queue 1
    item 5 ("CUDA-event ``measured`` profiling")."""

    name = "measured"

    def profile(self, ctx: ProfileContext, spec: SweepSpec = SweepSpec(),
                **opts) -> PerfMap:
        raise NotImplementedError(
            "the measured profiling backend is not ported yet: CUDA-event "
            "timing of the session's executables is ROADMAP queue 1 item 5; "
            "use backend='simulated' or 'trace'")


# --------------------------------------------------------------------------
# trace replay
# --------------------------------------------------------------------------

@register_backend
class TraceBackend(ProfileBackend):
    """Replay a saved performance-map artifact (no inference runs)."""

    name = "trace"

    def profile(self, ctx: Optional[ProfileContext] = None,
                spec: SweepSpec = SweepSpec(), *,
                path: Optional[str] = None,
                perfmap: Optional[PerfMap] = None) -> PerfMap:
        if perfmap is not None:
            return perfmap
        if path is None:
            raise ValueError("trace backend replays a recorded profile: "
                             "pass path=<saved perf-map JSON> or perfmap=")
        return PerfMap.load(path)
