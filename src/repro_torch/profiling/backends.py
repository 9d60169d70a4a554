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
* ``measured`` — times the **session's own registered plan executables**
  on its device (CUDA events on the card, the host clock on the CPU),
  scales the compute curve to the target hardware profile, and composes it
  with the modeled staging/wire terms for each swept bandwidth.  Sessions
  whose plans run in one process only: a plan partitioned over an
  initialised seq group raises (ROADMAP queue 1 item [5.1]).
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
    ``device`` is where the measured backend puts its inputs (the card
    when it is not given).
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
    device: Any = None                        # measured inputs' device

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
    """Times the session's registered plan executables on its device.

    The compute curve is **measured** per (plan × batch) and normalized so
    the anchor plan's first swept batch matches the hardware profile's
    prediction (device-shape-of-curve × target-absolute-level, as a real
    fleet would calibrate once); staging/wire are modeled from the link
    profile at each swept bandwidth.  Distributed plans charge each device
    ``1/P`` of the measured single-process compute plus the coordination
    overhead.  On a CUDA device each call is timed between CUDA events.

    A plan partitioned over an initialised seq group runs the real staged
    exchange, so its time would already hold the staging the backend adds
    from the link profile: such sessions raise (ROADMAP queue 1 item
    [5.1]).

    ``last_times`` and ``last_scale`` report the last profile: the measured
    median seconds per plan key and batch, and the anchor scale (the
    hardware profile's anchor compute over the measured anchor time; 1 when
    the profile predicts this device exactly).
    """

    name = "measured"
    last_times: Dict[str, Dict[int, float]] = {}
    last_scale: Optional[float] = None

    def profile(self, ctx: ProfileContext, spec: SweepSpec = SweepSpec(), *,
                iters: int = 3, warmup: int = 1) -> PerfMap:
        from repro_torch.utils.timing import timeit_torch
        if ctx is None or ctx.cfg is None or not ctx.execs:
            raise ValueError(
                "measured backend profiles the session's own executables: "
                "build the context via InferenceSession.profile_context() "
                "(register plans first), or pass cfg= and execs=")
        _refuse_seq_group(ctx)
        workload = ctx.workload or workload_from_config(ctx.cfg, ctx.seq_len)
        model = ctx.edge_model(workload)
        device = "cuda" if ctx.device is None else ctx.device
        pm = PerfMap()
        anchor = "local" if "local" in ctx.execs else next(iter(ctx.execs))
        arch = getattr(ctx.cfg, "name", "?")
        scale = None
        self.last_times = {key: {} for key in ctx.execs}
        for B in spec.batches:
            inputs = _dummy_batch(ctx.cfg, B, workload.n_tokens, device)
            times = {key: timeit_torch(fn, inputs, iters=iters,
                                       warmup=warmup)
                     for key, fn in ctx.execs.items()}
            if scale is None:      # anchor: first swept batch of one plan
                scale = (model.local(B)["compute_ms"] / 1e3) / times[anchor]
            for key, t in times.items():
                self.last_times[key][B] = t
                plan = self._plan_for(ctx, key, workload.n_tokens)
                compute_ms = t * scale * 1e3
                meta = {"measured": True, "arch": arch}
                if not plan.distributed:
                    r = model.pack(B, compute_ms, 0.0, 0.0, boards=1)
                    pm.put(plan.to_perf_key(B), _entry(r, meta))
                    continue
                P = max(plan.seq_shards, 1)
                L = plan.L if plan.L > 0 else None
                per_dev_ms = compute_ms / P + model.c.coord_overhead_ms
                for bw in spec.bandwidths_mbps:
                    if plan.codec:     # non-default codec: transport terms
                        from repro_torch.transport import exchange_cost
                        terms = exchange_cost(
                            plan.codec, n_tokens=workload.n_tokens,
                            d_model=workload.d_model,
                            bytes_per_el=workload.bytes_per_el, batch=B,
                            P=P, n_layers=workload.n_layers,
                            bandwidth_mbps=bw, profile=ctx.link,
                            link=plan.link or "staged", L=plan.L,
                            param=plan.codec_param)
                        r = model.pack(B, per_dev_ms + terms["decode_ms"],
                                       terms["staging_ms"],
                                       terms["comm_ms"], boards=P)
                        pm.put(plan.to_perf_key(B, bw),
                               _entry(r, dict(
                                   meta, codec=plan.codec,
                                   wire_bytes=terms["wire_bytes"])))
                        continue
                    rm = model.distributed(B, bw, P, L=L)
                    r = model.pack(B, per_dev_ms, rm["staging_ms"],
                                   rm["comm_ms"], boards=P)
                    pm.put(plan.to_perf_key(B, bw),
                           _entry(r, dict(meta, L=plan.L)))
        self.last_scale = scale
        return _stamp(pm, ctx, from_profiles=ctx.cost_model is None)

    @staticmethod
    def _plan_for(ctx: ProfileContext, key: str, n_tokens: int):
        plan = ctx.plans.get(key)
        if plan is None:                        # hand-wired execs table
            from repro_torch.api.plan import ExecutionPlan
            plan = ExecutionPlan.parse(key).resolve_L(n_tokens)
        return plan


def _refuse_seq_group(ctx: ProfileContext) -> None:
    """Raise when a registered plan is partitioned over a seq group that
    this process has initialised: its executable runs the real staged
    exchange, and the backend would add modeled staging on top."""
    from repro_torch.core.exchange import partitioned
    from repro_torch.core.seq_group import has_seq_group
    for key, plan in ctx.plans.items():
        xcfg = plan.to_exchange_config()
        if partitioned(xcfg) and has_seq_group(xcfg.seq_axis):
            raise NotImplementedError(
                f"measured profiling of plan {key!r}, partitioned over the "
                f"initialised seq group {xcfg.seq_axis!r}, is not ported: "
                f"its time would already hold the staged exchange that the "
                f"backend models on top (ROADMAP queue 1 item [5.1]); "
                f"profile a single-process session (local, prism_sim)")


def _dummy_batch(cfg, batch: int, seq_len: int, device) -> Dict[str, Any]:
    """Zero-filled inputs for the deployed config's family on ``device`` —
    tokens or images as the registry prescribes."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import registry
    shape = ShapeSpec("profiling", seq_len, batch, "prefill")
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in registry.input_specs(cfg, shape).items()}


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
