"""Transport links — *how* exchanged bytes travel, with per-stage costs.

The paper's central measurement is that GLOO-over-WiFi communication is not
wire-limited but **staging**-limited: every collective crosses
GPU→CPU→GPU because embedded boards have no NVLink/PCIe peer path.  A
:class:`TransportLink` models one such path as explicit stages — host
staging, wire, payload reconstruction — each costed from the profiled
:class:`~repro_torch.profiling.hardware.LinkProfile` constants and the live
bandwidth estimate:

* ``staged`` — the CPU-memory path (GLOO): D2H + H2D pinned copies through
  the profile's size-dependent staging curve, plus wire time and per-round
  RTT.
* ``direct`` — a peer/collective path (NVLink, TPU ICI): no host hop; wire
  time and RTT only.

:func:`exchange_cost` composes a codec with a link into the full
per-dispatch accounting the profiling backends and the session's telemetry
share — wire bytes, staged bytes, per-stage milliseconds, and the achieved
compression ratio.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Type

from repro_torch.transport.codecs import CodecSpec, get_codec


class TransportError(RuntimeError):
    """One exchange over a link failed (flap, reset, staged-copy abort).

    Raised/recorded by the fault-injection layer and consumed by the
    retry machinery: a transport error is *retryable* by construction —
    the payload never left intact, so re-sending cannot duplicate work.
    ``worker`` names the endpoint whose dispatch failed; ``stage`` is the
    link stage that broke (``"staging"`` | ``"wire"`` | ``"decode"``).
    """

    def __init__(self, msg: str, worker: str = "", stage: str = "wire"):
        super().__init__(msg)
        self.worker = worker
        self.stage = stage
        self.retryable = True


@dataclasses.dataclass(frozen=True)
class LinkCost:
    """Per-stage cost of moving one dispatch's exchange traffic."""
    staging_ms: float = 0.0     # GPU↔CPU pinned copies (staged links only)
    wire_ms: float = 0.0        # bytes / bandwidth + per-round RTT
    decode_ms: float = 0.0      # payload reconstruction on the receiver

    @property
    def total_ms(self) -> float:
        return self.staging_ms + self.wire_ms + self.decode_ms

    def stages(self) -> Dict[str, float]:
        return {"staging_ms": self.staging_ms, "wire_ms": self.wire_ms,
                "decode_ms": self.decode_ms}


class TransportLink:
    """Protocol: subclass, set ``name``/``staged``, implement ``cost``."""

    name: str = ""
    staged: bool = False       # does traffic cross host memory?

    def cost(self, *, wire_bytes_per_call: float, n_calls: int,
             bandwidth_mbps: float, profile,
             raw_bytes_total: float = 0.0,
             decode_bw: float = 0.0) -> LinkCost:
        raise NotImplementedError

    @staticmethod
    def _wire_ms(wire_bytes_per_call, n_calls, bandwidth_mbps, profile):
        # Mbps → bytes/ms = BW·125 (the cost-model convention)
        return (wire_bytes_per_call * n_calls / (bandwidth_mbps * 125.0)
                + n_calls * profile.wire_rtt_ms)

    @staticmethod
    def _decode_ms(raw_bytes_total, decode_bw):
        if decode_bw <= 0 or raw_bytes_total <= 0:
            return 0.0
        return raw_bytes_total / decode_bw * 1e3


_REGISTRY: Dict[str, TransportLink] = {}


def register_link(cls: Type[TransportLink]) -> Type[TransportLink]:
    name = getattr(cls, "name", "")
    if not name:
        raise ValueError(f"{cls.__name__} must define a non-empty `name`")
    if name in _REGISTRY:
        raise ValueError(f"link {name!r} already registered")
    _REGISTRY[name] = cls()
    return cls


def get_link(name: str) -> TransportLink:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown transport link {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def list_links() -> List[str]:
    return sorted(_REGISTRY)


@register_link
class DirectLink(TransportLink):
    """Peer/collective path (NVLink, TPU ICI): wire + RTT, no host hop."""

    name = "direct"
    staged = False

    def cost(self, *, wire_bytes_per_call, n_calls, bandwidth_mbps, profile,
             raw_bytes_total=0.0, decode_bw=0.0) -> LinkCost:
        return LinkCost(
            staging_ms=0.0,
            wire_ms=self._wire_ms(wire_bytes_per_call, n_calls,
                                  bandwidth_mbps, profile),
            decode_ms=self._decode_ms(raw_bytes_total, decode_bw))


@register_link
class StagedLink(TransportLink):
    """CPU-memory path (GLOO): every wire byte is copied D2H then H2D
    through the profile's size-dependent pinned-copy curve (identical math
    to ``EdgeConstants.staging_ms`` — the two must not drift)."""

    name = "staged"
    staged = True

    def cost(self, *, wire_bytes_per_call, n_calls, bandwidth_mbps, profile,
             raw_bytes_total=0.0, decode_bw=0.0) -> LinkCost:
        staged_per_call = 2.0 * wire_bytes_per_call          # D2H + H2D
        bw = (profile.staging_bw_base + profile.staging_bw_extra
              * staged_per_call
              / (staged_per_call + profile.staging_knee_bytes))
        per_call = profile.staging_fixed_ms + staged_per_call / bw * 1e3
        return LinkCost(
            staging_ms=per_call * n_calls + profile.sync_overhead_ms,
            wire_ms=self._wire_ms(wire_bytes_per_call, n_calls,
                                  bandwidth_mbps, profile),
            decode_ms=self._decode_ms(raw_bytes_total, decode_bw))


# ---------------------------------------------------------------------------
# codec × link accounting — shared by profiling backends and telemetry
# ---------------------------------------------------------------------------

def exchange_wire_bytes(codec_name: str, *, n_tokens: int, d_model: int,
                        bytes_per_el: int, batch: int, P: int,
                        n_layers: int, L: int = 0, param: int = 0) -> int:
    """Total bytes one device puts on the wire for a full forward pass
    (one collective per layer), under the cost model's convention of a
    ``d_model``-wide per-token K/V payload."""
    if P <= 1:
        return 0
    codec = get_codec(codec_name)
    spec = CodecSpec(L=L, param=param)
    Np = n_tokens // P + (n_tokens % P > 0)
    shipped = (P - 1) * (L if codec.summarizing else Np)
    per_tok = codec.token_wire_bytes(d_model, bytes_per_el, spec)
    return int(shipped * per_tok * batch * n_layers)


def exchange_cost(codec_name: str, *, n_tokens: int, d_model: int,
                  bytes_per_el: int, batch: int, P: int, n_layers: int,
                  bandwidth_mbps: float, profile, link: str = "staged",
                  L: int = 0, param: int = 0) -> Dict[str, float]:
    """Full per-dispatch exchange accounting for one (codec, link) pair.

    Returns wire/staged byte totals, the per-stage latency decomposition
    (staging / wire / decode), and the achieved compression ratio relative
    to full-tensor exchange of the same remote tokens.
    """
    codec = get_codec(codec_name)
    lnk = get_link(link)
    spec = CodecSpec(L=L, param=param)
    Np = n_tokens // P + (n_tokens % P > 0)
    raw_remote = (P - 1) * Np * d_model * bytes_per_el * batch  # per call
    wire_total = exchange_wire_bytes(
        codec_name, n_tokens=n_tokens, d_model=d_model,
        bytes_per_el=bytes_per_el, batch=batch, P=P, n_layers=n_layers,
        L=L, param=param)
    wire_per_call = wire_total / max(n_layers, 1)
    # summarizing codecs are consumed directly (no per-token reconstruction)
    raw_total = 0.0 if codec.summarizing else raw_remote * n_layers
    cost = lnk.cost(wire_bytes_per_call=wire_per_call, n_calls=n_layers,
                    bandwidth_mbps=bandwidth_mbps, profile=profile,
                    raw_bytes_total=raw_total, decode_bw=codec.decode_bw)
    return {
        "wire_bytes": wire_total,
        "staged_bytes": (2.0 * wire_total) if lnk.staged else 0.0,
        "staging_ms": cost.staging_ms,
        "comm_ms": cost.wire_ms,
        "decode_ms": cost.decode_ms,
        "ratio": (raw_remote * n_layers) / max(wire_total, 1),
    }


def plan_wire_bytes(plan, cfg, batch: int,
                    n_tokens: Optional[int] = None) -> int:
    """Bytes-on-wire one dispatch of ``plan`` moves (0 for local plans) —
    the per-request telemetry `DispatchRecord`/`Completion` report."""
    if not plan.distributed or plan.seq_shards <= 1:
        return 0
    if not n_tokens or n_tokens <= 0:
        from repro_torch.profiling.sweep import workload_from_config
        n_tokens = workload_from_config(cfg).n_tokens
    codec = plan.effective_codec or "identity"
    L = plan.L
    if get_codec(codec).summarizing and L <= 0 and plan.cr > 0:
        from repro_torch.core.segment_means import cr_to_L
        L = cr_to_L(n_tokens, plan.seq_shards, plan.cr)
    return exchange_wire_bytes(
        codec, n_tokens=n_tokens, d_model=cfg.d_model,
        bytes_per_el=cfg.torch_dtype.itemsize, batch=batch, P=plan.seq_shards,
        n_layers=cfg.n_layers, L=L, param=plan.codec_param)
