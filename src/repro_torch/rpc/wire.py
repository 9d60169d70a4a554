"""Length-prefixed, versioned, CRC-framed wire protocol for fleet workers.

One frame carries one message::

    +----+-----+------+--------+--------+-------+================+=========+
    | RW | ver | kind | hlen   | plen   | crc32 |  JSON header   | payload |
    | 2B | u16 | u8   | u32    | u64    | u32   |  (hlen bytes)  | (plen)  |
    +----+-----+------+--------+--------+-------+================+=========+

The JSON header holds the message's scalar fields plus per-tensor metadata;
the payload is the concatenation of the *raw encoded leaves* of every tensor
field, serialized through the :mod:`repro_torch.transport` codec registry.
That makes bytes-on-wire for a tensor exactly ``codec.wire_bytes(shape,
dtype, spec)`` — the same quantity the profiler sweeps over and the policy
table charges — an invariant the property tests assert against real
sockets.  The port's frames are the JAX package's (``repro.rpc.wire``)
byte for byte, so a port client drives a JAX worker and the reverse.

Versioning rule: the version is bumped only when an existing field or kind
changes meaning; *adding* header fields or new kinds is compatible.  A
receiver accepts frames with ``version <= PROTOCOL_VERSION`` (unknown header
fields are ignored) and rejects newer frames with :class:`FrameError` —
kind ids and field names are never reused.

Failures surface as typed :class:`repro_torch.transport.TransportError`
subclasses so the fleet's existing retry/breaker machinery (which keys on
``TransportError.retryable``) handles real socket faults unchanged:

* :class:`WireTimeout`  — no/partial frame within the deadline
* :class:`WireClosed`   — EOF, connection reset, broken pipe
* :class:`FrameError`   — bad magic, unsupported version, CRC mismatch,
  malformed header, truncated payload (stream desync: close and reconnect)
"""
from __future__ import annotations

import dataclasses
import json
import socket
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.transport.codecs import CodecSpec, get_codec
from repro_torch.transport.links import TransportError

PROTOCOL_VERSION = 1

MAGIC = b"RW"
# magic(2s) version(u16) kind(u8) header_len(u32) payload_len(u64) crc(u32)
_FRAME = struct.Struct(">2sHBIQI")
FRAME_OVERHEAD = _FRAME.size

# Refuse absurd frames before allocating: headers are small JSON; payloads
# are bounded by the largest tensor the fleet ships (KV partitions, token
# arrays).  A corrupt length field otherwise turns into an OOM.
MAX_HEADER_BYTES = 16 << 20
MAX_PAYLOAD_BYTES = 4 << 30


class WireTimeout(TransportError):
    """recv/send did not complete within the deadline."""

    def __init__(self, msg, worker=""):
        super().__init__(msg, worker=worker, stage="rpc-timeout")


class WireClosed(TransportError):
    """Peer closed the connection (EOF, reset, broken pipe)."""

    def __init__(self, msg, worker=""):
        super().__init__(msg, worker=worker, stage="rpc-closed")


class FrameError(TransportError):
    """Corrupt or incompatible frame: the stream is desynchronized and the
    connection must be dropped (the client reconnects and re-submits)."""

    def __init__(self, msg, worker=""):
        super().__init__(msg, worker=worker, stage="rpc-frame")


# ---------------------------------------------------------------------------
# tensor (de)serialization through the codec registry
# ---------------------------------------------------------------------------

def _dtype_name(dt: torch.dtype) -> str:
    """The numpy name of a torch dtype ("float32", "int8", "bfloat16"),
    which is the name the JAX package's frames carry."""
    return str(dt).removeprefix("torch.")


def _resolve_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise FrameError(f"unsupported tensor dtype {name!r}")
    return dt


def _as_tensor(x) -> torch.Tensor:
    """A CPU tensor of ``x`` (a tensor, or a numpy array — a bfloat16 one
    as the JAX package hands it over, through its 16-bit pattern)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _tensor_bytes(leaf: torch.Tensor) -> bytes:
    leaf = leaf.detach().cpu().contiguous()
    if leaf.dtype == torch.bfloat16:
        leaf = leaf.view(torch.int16)
    return leaf.numpy().tobytes()


def pack_tensor(x, codec: str = "identity",
                spec: Optional[CodecSpec] = None) -> Tuple[Dict, bytes]:
    """Encode ``x`` with a registered codec and flatten to (meta, bytes).

    The byte string is exactly the encoded leaves back to back — its length
    is the codec's ``wire_bytes`` for this tensor (asserted here, so a codec
    whose accounting drifts from its encoding fails loudly at the wire).
    Encoding runs on the CPU; a bfloat16 leaf goes out as its 16-bit
    pattern under the dtype name ``"bfloat16"``, so the frame is the JAX
    package's byte for byte.
    """
    c = get_codec(codec)
    spec = spec or CodecSpec()
    arr = _as_tensor(x)
    payload = c.encode(arr, spec)
    leaves: List[Dict] = []
    chunks: List[bytes] = []
    for k in sorted(payload):
        leaf = payload[k]
        raw = _tensor_bytes(leaf)
        leaves.append({"k": k, "dtype": _dtype_name(leaf.dtype),
                       "shape": list(leaf.shape), "n": len(raw)})
        chunks.append(raw)
    blob = b"".join(chunks)
    expect = c.wire_bytes(tuple(arr.shape), arr.dtype, spec)
    if len(blob) != expect:
        raise FrameError(f"codec {codec!r} wire accounting drifted: encoded "
                         f"{len(blob)} bytes but wire_bytes says {expect}")
    meta = {"codec": codec, "L": spec.L, "param": spec.param,
            "shape": list(arr.shape), "dtype": _dtype_name(arr.dtype),
            "leaves": leaves}
    return meta, blob


def unpack_tensor(meta: Dict, blob: bytes) -> torch.Tensor:
    """Inverse of :func:`pack_tensor`: rebuild leaves, decode through the
    codec.  Bit-exact with a local decode of the same encoded payload;
    returns a CPU tensor."""
    payload = {}
    off = 0
    for leaf in meta["leaves"]:
        n = int(leaf["n"])
        if off + n > len(blob):
            raise FrameError(f"tensor payload truncated: leaf {leaf['k']!r} "
                             f"needs {n} bytes at offset {off}, "
                             f"have {len(blob)}")
        dt = _resolve_dtype(leaf["dtype"])
        shape = [int(s) for s in leaf["shape"]]
        payload[leaf["k"]] = (
            torch.frombuffer(bytearray(blob[off:off + n]), dtype=dt)
            if n else torch.empty(0, dtype=dt)).reshape(shape)
        off += n
    if off != len(blob):
        raise FrameError(f"tensor payload has {len(blob) - off} trailing "
                         "bytes")
    c = get_codec(meta["codec"])
    spec = CodecSpec(L=int(meta.get("L", 0)), param=int(meta.get("param", 0)))
    return c.decode(payload, spec, shape=tuple(int(s) for s in meta["shape"]),
                    dtype=_resolve_dtype(meta["dtype"]))


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------

_KINDS: Dict[int, Type["Message"]] = {}


def message(cls):
    """Register a dataclass message under its ``KIND`` byte."""
    cls = dataclasses.dataclass(cls)
    kind = cls.KIND
    if kind in _KINDS:
        raise ValueError(f"kind {kind} already taken by "
                         f"{_KINDS[kind].__name__}")
    _KINDS[kind] = cls
    return cls


class Message:
    """Base: scalar dataclass fields ride in the JSON header; fields named
    in ``TENSORS`` (value → codec-field or fixed codec name) ride in the
    payload through the codec registry."""

    KIND = 0
    TENSORS: Dict[str, str] = {}   # field -> codec name | "@field" indirection

    def _codec_for(self, field: str) -> str:
        src = self.TENSORS[field]
        if src.startswith("@"):
            return getattr(self, src[1:])
        return src

    def _spec_for(self, field: str) -> CodecSpec:
        return CodecSpec(L=int(getattr(self, "codec_l", 0)),
                         param=int(getattr(self, "codec_param", 0)))

    def encode_frame(self) -> bytes:
        scalars = {}
        for f in dataclasses.fields(self):
            if f.name in self.TENSORS:
                continue
            scalars[f.name] = _jsonable(getattr(self, f.name))
        tensors = []
        blobs = []
        for field in self.TENSORS:
            val = getattr(self, field)
            if val is None:
                continue
            meta, blob = pack_tensor(val, self._codec_for(field),
                                     self._spec_for(field))
            meta["field"] = field
            tensors.append(meta)
            blobs.append(blob)
        header = json.dumps({"f": scalars, "t": tensors},
                            separators=(",", ":")).encode()
        payload = b"".join(blobs)
        crc = zlib.crc32(header)
        crc = zlib.crc32(payload, crc)
        return _FRAME.pack(MAGIC, PROTOCOL_VERSION, self.KIND,
                           len(header), len(payload), crc) + header + payload

    @classmethod
    def decode_frame(cls, kind: int, header: bytes, payload: bytes
                     ) -> "Message":
        try:
            doc = json.loads(header.decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise FrameError(f"malformed frame header: {e}") from None
        mcls = _KINDS.get(kind)
        if mcls is None:
            raise FrameError(f"unknown message kind {kind}")
        known = {f.name for f in dataclasses.fields(mcls)}
        # forward compatibility: ignore header fields this build doesn't know
        fields = {k: v for k, v in doc.get("f", {}).items() if k in known}
        off = 0
        for meta in doc.get("t", []):
            n = sum(int(l["n"]) for l in meta["leaves"])
            if off + n > len(payload):
                raise FrameError(
                    f"frame payload truncated: tensor {meta.get('field')!r} "
                    f"needs {n} bytes at offset {off}, have {len(payload)}")
            if meta.get("field") in mcls.TENSORS:
                fields[meta["field"]] = unpack_tensor(
                    meta, payload[off:off + n])
            off += n
        try:
            return mcls(**fields)
        except TypeError as e:
            raise FrameError(f"{mcls.__name__}: {e}") from None


def _jsonable(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.ndarray, torch.Tensor)):
        return v.tolist()
    if isinstance(v, tuple):
        return list(v)
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    return v


@message
class Hello(Message):
    """Client → worker greeting; the reply describes the serving runtime."""
    KIND = 1
    name: str = ""
    protocol: int = PROTOCOL_VERSION


@message
class HelloAck(Message):
    KIND = 2
    name: str = ""
    pid: int = 0
    arch: str = ""
    n_slots: int = 0
    chunk: int = 0
    max_len: int = 0
    queue_size: int = 0


@message
class SubmitRequest(Message):
    """One serving request; the prompt tensor rides through ``codec``."""
    KIND = 3
    request_id: int = 0
    n_new: int = 0
    seed: int = 0
    temperature: float = 0.0
    slo_ms: Optional[float] = None
    arrival_ts: float = 0.0
    codec: str = "identity"
    codec_l: int = 0
    codec_param: int = 0
    # trace context (added post-v1; unknown header fields are ignored by
    # older builds, so the version stays 1): the worker stamps its spans
    # with trace_id and parents them under parent_span — the client-side
    # dispatch span — so one request yields one tree across the process
    # boundary.
    trace_id: str = ""
    parent_span: str = ""
    prompt: Optional[Any] = None
    TENSORS = {"prompt": "@codec"}


@message
class TokenChunk(Message):
    """Streamed decode progress: tokens[start:start+len) of a request."""
    KIND = 4
    request_id: int = 0
    start: int = 0
    # spans the worker finished since the last chunk for this request
    # (span_to_dict docs); empty for untraced runs and ignored by old
    # clients.
    spans: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    tokens: Optional[Any] = None
    TENSORS = {"tokens": "identity"}


@message
class CompletionMsg(Message):
    KIND = 5
    request_id: int = 0
    plan_key: str = ""
    admitted_ts: float = 0.0
    finished_ts: float = 0.0
    codec: str = ""
    wire_bytes: int = 0
    extrapolated: bool = False
    # remaining finished spans for this request (those not already shipped
    # on TokenChunk frames)
    spans: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    tokens: Optional[Any] = None
    TENSORS = {"tokens": "identity"}


@message
class Heartbeat(Message):
    """Ping (client → worker) / pong (worker → client, ``pong=True``); the
    pong carries the remote runtime's ``stats_snapshot()``."""
    KIND = 6
    seq: int = 0
    t: float = 0.0
    pong: bool = False
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)


@message
class Calibrate(Message):
    """Run ``calibrate_codec_bws`` on the worker's own process."""
    KIND = 7
    shape: Tuple[int, ...] = (4, 64, 256)
    iters: int = 3
    warmup: int = 1


@message
class CalibrateResult(Message):
    KIND = 8
    bws: Dict[str, float] = dataclasses.field(default_factory=dict)
    measured: bool = True


@message
class Profile(Message):
    """Re-run the profiling sweep on the worker; optional measured codec
    bandwidths to install first (empty dict = keep current)."""
    KIND = 9
    codec_bws: Dict[str, float] = dataclasses.field(default_factory=dict)
    bandwidths: List[float] = dataclasses.field(default_factory=list)


@message
class ProfileResult(Message):
    KIND = 10
    perfmap: Dict[str, Any] = dataclasses.field(default_factory=dict)


@message
class Drain(Message):
    KIND = 11


@message
class DrainResult(Message):
    """Ids of requests the worker gave back (client re-routes them)."""
    KIND = 12
    request_ids: List[int] = dataclasses.field(default_factory=list)


@message
class SetBandwidth(Message):
    KIND = 13
    mbps: float = 0.0


@message
class Shutdown(Message):
    KIND = 14


@message
class ErrorMsg(Message):
    KIND = 15
    detail: str = ""
    request_id: int = -1


# ---------------------------------------------------------------------------
# socket I/O
# ---------------------------------------------------------------------------

def _recv_exact(sock: socket.socket, n: int, *, worker: str = "",
                first: bool = False) -> bytes:
    """Read exactly ``n`` bytes; EOF at a frame boundary is a clean close,
    EOF mid-frame is a truncated frame — both are :class:`WireClosed` but
    the message distinguishes them for the fault log."""
    buf = bytearray()
    while len(buf) < n:
        try:
            part = sock.recv(n - len(buf))
        except socket.timeout:
            raise WireTimeout(
                f"timed out after {len(buf)}/{n} bytes", worker=worker
            ) from None
        except (ConnectionResetError, BrokenPipeError) as e:
            raise WireClosed(f"connection reset: {e}", worker=worker) \
                from None
        except OSError as e:
            raise WireClosed(f"socket error: {e}", worker=worker) from None
        if not part:
            if first and not buf:
                raise WireClosed("peer closed the connection", worker=worker)
            raise WireClosed(
                f"connection closed mid-frame ({len(buf)}/{n} bytes)",
                worker=worker)
        buf += part
    return bytes(buf)


def send_message(sock: socket.socket, msg: Message, *,
                 worker: str = "") -> int:
    """Send one frame; returns the exact bytes written to the socket."""
    frame = msg.encode_frame()
    try:
        sock.sendall(frame)
    except socket.timeout:
        raise WireTimeout(f"send of {len(frame)}B frame timed out",
                          worker=worker) from None
    except (ConnectionResetError, BrokenPipeError) as e:
        raise WireClosed(f"connection reset on send: {e}", worker=worker) \
            from None
    except OSError as e:
        raise WireClosed(f"socket error on send: {e}", worker=worker) \
            from None
    return len(frame)


def recv_message(sock: socket.socket, *, timeout: Optional[float] = None,
                 worker: str = "") -> Tuple[Message, int]:
    """Receive one frame; returns (message, bytes read off the socket).

    Raises :class:`WireTimeout` / :class:`WireClosed` / :class:`FrameError`.
    """
    old = sock.gettimeout()
    if timeout is not None:
        sock.settimeout(timeout)
    try:
        head = _recv_exact(sock, FRAME_OVERHEAD, worker=worker, first=True)
        magic, version, kind, hlen, plen, crc = _FRAME.unpack(head)
        if magic != MAGIC:
            raise FrameError(f"bad magic {magic!r} (stream desync?)",
                             worker=worker)
        if version > PROTOCOL_VERSION:
            raise FrameError(
                f"peer speaks protocol v{version}; this build reads "
                f"<= v{PROTOCOL_VERSION}", worker=worker)
        if hlen > MAX_HEADER_BYTES or plen > MAX_PAYLOAD_BYTES:
            raise FrameError(f"implausible frame lengths header={hlen} "
                             f"payload={plen}", worker=worker)
        header = _recv_exact(sock, hlen, worker=worker)
        payload = _recv_exact(sock, plen, worker=worker)
        got = zlib.crc32(payload, zlib.crc32(header))
        if got != crc:
            raise FrameError(f"CRC mismatch (expected {crc:#010x}, got "
                             f"{got:#010x})", worker=worker)
        msg = Message.decode_frame(kind, header, payload)
        return msg, FRAME_OVERHEAD + hlen + plen
    finally:
        try:
            sock.settimeout(old)
        except OSError:
            pass   # peer may have vanished; the raised error already says so
