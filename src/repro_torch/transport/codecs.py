"""Exchange codecs — what the bytes on the wire *are* (byte accounting).

Port of ``repro.transport.codecs``: the codec registry with
``identity`` (the Voltage full-tensor payload), ``segment_means`` (the
PRISM compressor), and ``int8`` / ``int4`` (per-tile symmetric
quantize–dequantize; the paged pool's cold pages go through them).  Their
``wire_bytes`` / ``token_wire_bytes`` feed the simulated profiling backend
and the session's per-dispatch telemetry; the int8/int4 payloads are bit
for bit the JAX package's on the same f32 input.  The sparse ``topk``
codec, codec exchanges inside the strategies and measured decode
bandwidths are ROADMAP queue 1 item 9.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Type

import numpy as np
import torch

# characters reserved by PerfKey ('|'), ExecutionPlan keys ('@', '+') and
# the sweep axis — a codec name must survive all three encodings
_RESERVED = set("|@+# \t\n")


def _itemsize(dtype) -> int:
    """Bytes per element of a torch or numpy dtype (or a dtype name)."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    if isinstance(dtype, str) and dtype == "bfloat16":
        return 2
    return np.dtype(dtype).itemsize


@dataclasses.dataclass(frozen=True)
class CodecSpec:
    """Static per-plan codec parameters.

    ``L``     — segment means per partition (``segment_means`` only).
    ``param`` — codec-specific knob: quantization tile size along the
                feature axis (0 = one scale per whole vector) for
                ``int8``/``int4``.
    """
    L: int = 0
    param: int = 0


class ExchangeCodec:
    """One way to put a K/V partition on the wire.

    ``encode``/``decode`` are functions of tensors + a static
    :class:`CodecSpec`.  ``wire_bytes`` is the exact payload size (equal to
    the summed bytes of the encoded tensors); ``token_wire_bytes`` is the
    model-level cost the profiler charges per shipped token.
    """

    name: str = ""
    summarizing: bool = False     # decoded payload has L tokens, not N
    lossless: bool = False
    default_param: int = 0        # default spec.param for parameterized codecs
    # reconstruction throughput (raw bytes/s) charged by the profiler as
    # decode time on the receiving device; 0 = free
    decode_bw: float = 0.0
    decode_bw_measured: bool = False

    # -- wire format ---------------------------------------------------------

    def encode(self, x: torch.Tensor, spec: CodecSpec) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def decode(self, payload: Dict[str, torch.Tensor], spec: CodecSpec,
               shape=None, dtype=None) -> torch.Tensor:
        raise NotImplementedError

    # -- accounting ----------------------------------------------------------

    def wire_bytes(self, shape, dtype, spec: CodecSpec) -> int:
        """Exact bytes on the wire for one encoded tensor."""
        raise NotImplementedError

    def token_wire_bytes(self, feat: int, bytes_per_el: int,
                         spec: CodecSpec) -> float:
        """Model-level wire bytes per shipped token of a ``feat``-wide
        payload (the profiler's per-token charge)."""
        raise NotImplementedError

    def ratio(self, shape, dtype, spec: CodecSpec) -> float:
        """Compression ratio: raw bytes / wire bytes."""
        raw = math.prod(shape) * _itemsize(dtype)
        return raw / max(self.wire_bytes(shape, dtype, spec), 1)

    def validate_spec(self, spec: CodecSpec) -> None:
        """Raise on parameters this codec cannot execute with."""


_REGISTRY: Dict[str, ExchangeCodec] = {}


def register_codec(cls: Type[ExchangeCodec]) -> Type[ExchangeCodec]:
    """Class decorator: instantiate and register under ``cls.name``."""
    name = getattr(cls, "name", "")
    if not name:
        raise ValueError(f"{cls.__name__} must define a non-empty `name`")
    if _RESERVED & set(name):
        raise ValueError(f"codec name {name!r} contains a reserved "
                         f"character (one of {''.join(sorted(_RESERVED))!r})")
    if not name[0].isalpha():
        # "mode@cr+codec" parsing disambiguates exponent '+' from the
        # codec separator by this property
        raise ValueError(f"codec name {name!r} must start with a letter")
    if name in _REGISTRY:
        raise ValueError(f"codec {name!r} already registered "
                         f"(by {type(_REGISTRY[name]).__name__})")
    _REGISTRY[name] = cls()
    return cls


def get_codec(name: str) -> ExchangeCodec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown exchange codec {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def list_codecs() -> List[str]:
    return sorted(_REGISTRY)


def payload_nbytes(payload: Dict[str, torch.Tensor]) -> int:
    """Summed bytes of an encoded payload (accounting cross-check)."""
    return sum(v.numel() * v.element_size() for v in payload.values())


@register_codec
class IdentityCodec(ExchangeCodec):
    """Full-tensor exchange (the Voltage baseline payload)."""

    name = "identity"
    lossless = True

    def encode(self, x, spec):
        return {"x": x}

    def decode(self, payload, spec, shape=None, dtype=None):
        return payload["x"]

    def wire_bytes(self, shape, dtype, spec):
        return math.prod(shape) * _itemsize(dtype)

    def token_wire_bytes(self, feat, bytes_per_el, spec):
        return feat * bytes_per_el


@register_codec
class SegmentMeansCodec(ExchangeCodec):
    """L column-wise means per partition (PRISM Eq. 1).  The decoded
    payload *is* the means — consumers apply the scaling-aware softmax
    rather than reconstructing per-token K/V."""

    name = "segment_means"
    summarizing = True

    def encode(self, x, spec):
        from repro_torch.core.segment_means import segment_means
        if spec.L <= 0:
            raise ValueError("segment_means codec needs spec.L > 0")
        return {"means": segment_means(x, spec.L, axis=1)}

    def decode(self, payload, spec, shape=None, dtype=None):
        return payload["means"]

    def wire_bytes(self, shape, dtype, spec):
        n = shape[1]
        return (math.prod(shape) // n) * spec.L * _itemsize(dtype)

    def token_wire_bytes(self, feat, bytes_per_el, spec):
        # full precision per shipped *mean*; the token-count reduction
        # N_p → L is applied by the caller (shipped-token accounting)
        return feat * bytes_per_el

    def validate_spec(self, spec):
        if spec.L <= 0:
            raise ValueError("segment_means codec needs L > 0")


# ---------------------------------------------------------------------------
# int8 / int4 — per-tile symmetric quantization
# ---------------------------------------------------------------------------

def _tile(feat: int, spec: CodecSpec) -> int:
    t = spec.param if spec.param > 0 else feat
    if feat % t != 0:
        raise ValueError(f"feature width {feat} not divisible into "
                         f"quantization tiles of {t}")
    return t


class _QuantCodec(ExchangeCodec):
    """Shared symmetric per-tile quantizer: one f32 scale per tile along
    the trailing (feature) axis, values in [-qmax, qmax], rounded half to
    even as ``jnp.round`` rounds."""

    qmax: int = 127

    def _scaled(self, x, spec):
        t = _tile(x.shape[-1], spec)
        xr = x.reshape(x.shape[:-1] + (x.shape[-1] // t, t)).float()
        scale = xr.abs().amax(dim=-1, keepdim=True) / self.qmax
        q = torch.round(xr / torch.clamp(scale, min=1e-12))
        q = torch.clamp(q, -self.qmax, self.qmax)
        return q, scale, xr.shape

    def _dequant(self, q, scale, spec, dtype):
        t = _tile(q.shape[-1], spec)
        xr = q.reshape(scale.shape + (t,)).float()
        out = (xr * scale[..., None]).reshape(q.shape)
        return out.to(dtype if dtype is not None else torch.float32)

    def wire_bytes(self, shape, dtype, spec):
        n_tiles = math.prod(shape) // _tile(shape[-1], spec)
        return self._payload_bytes(math.prod(shape)) + 4 * n_tiles

    def token_wire_bytes(self, feat, bytes_per_el, spec):
        t = spec.param if spec.param > 0 else feat
        return self._payload_bytes(feat) + 4.0 * -(-feat // t)

    def _payload_bytes(self, n_el: int) -> int:
        raise NotImplementedError


@register_codec
class Int8Codec(_QuantCodec):
    name = "int8"
    decode_bw = 8e8       # modeled dequantization throughput, raw bytes/s

    def encode(self, x, spec):
        q, scale, qshape = self._scaled(x, spec)
        return {"q": q.to(torch.int8).reshape(x.shape),
                "scale": scale.reshape(qshape[:-1])}

    def decode(self, payload, spec, shape=None, dtype=None):
        return self._dequant(payload["q"], payload["scale"], spec, dtype)

    def _payload_bytes(self, n_el):
        return n_el


@register_codec
class Int4Codec(_QuantCodec):
    """4-bit symmetric quantization, two values packed per byte (low
    nibble first, each biased by 8)."""

    name = "int4"
    qmax = 7
    decode_bw = 2e8

    def encode(self, x, spec):
        if x.shape[-1] % 2 != 0:
            raise ValueError("int4 codec needs an even feature width "
                             f"(got {x.shape[-1]})")
        q, scale, qshape = self._scaled(x, spec)
        biased = (q + 8).to(torch.uint8).reshape(x.shape)      # 1..15
        packed = biased[..., 0::2] | (biased[..., 1::2] << 4)
        return {"q": packed, "scale": scale.reshape(qshape[:-1])}

    def decode(self, payload, spec, shape=None, dtype=None):
        packed = payload["q"]
        lo = (packed & 0xF).to(torch.int32)
        hi = (packed >> 4).to(torch.int32)
        q = torch.stack([lo, hi], dim=-1).reshape(
            packed.shape[:-1] + (2 * packed.shape[-1],)) - 8
        return self._dequant(q, payload["scale"], spec, dtype)

    def wire_bytes(self, shape, dtype, spec):
        n_tiles = math.prod(shape) // _tile(shape[-1], spec)
        return math.prod(shape) // 2 + 4 * n_tiles

    def _payload_bytes(self, n_el):
        return n_el / 2

    def validate_spec(self, spec):
        if spec.param % 2 != 0:
            raise ValueError("int4 tile size must be even "
                             f"(got {spec.param})")
