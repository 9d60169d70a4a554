"""Exchange codecs — what the bytes on the wire *are* (byte accounting).

Port of ``repro.transport.codecs``: the codec registry with the two codecs
the single-device slice needs for its accounting — ``identity`` (the
Voltage full-tensor payload) and ``segment_means`` (the PRISM compressor).
Their ``wire_bytes`` / ``token_wire_bytes`` feed the simulated profiling
backend and the session's per-dispatch telemetry.  The quantizing and
sparse codecs (``int8`` / ``int4`` / ``topk``) and measured decode
bandwidths come with the transport-codec slice (ROADMAP queue 1 item 9).
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
    ``param`` — codec-specific knob (quantization tile / top-k) for the
                codecs of a later slice.
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
