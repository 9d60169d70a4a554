"""repro_torch.rpc — the fleet's real worker-process boundary.

* :mod:`repro_torch.rpc.wire` — length-prefixed, versioned, CRC-framed message
  protocol; tensor payloads serialized through the
  :mod:`repro_torch.transport` codec registry so bytes-on-wire is the same
  quantity the policy sweeps over.
* :mod:`repro_torch.rpc.worker` — ``WorkerServer`` + the
  ``python -m repro_torch.rpc.worker`` subprocess entrypoint (session +
  ``ServingRuntime`` + on-process calibration/profiling).
* :mod:`repro_torch.rpc.client` — :class:`RpcWorker`, a drop-in
  :class:`~repro_torch.fleet.registry.Worker` whose heartbeats, faults, and
  calibration cross an actual socket.
"""
from repro_torch.rpc.wire import (  # noqa: F401
    FRAME_OVERHEAD, PROTOCOL_VERSION, FrameError, Message, TransportError,
    WireClosed, WireTimeout, pack_tensor, recv_message, send_message,
    unpack_tensor,
)
from repro_torch.rpc.client import RpcWorker  # noqa: F401


def __getattr__(name):
    # lazy: `python -m repro_torch.rpc.worker` must not find repro_torch.rpc.worker
    # already imported by its own package __init__ (runpy warns)
    if name in ("WorkerServer", "worker_main"):
        from repro_torch.rpc import worker
        return getattr(worker, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "FRAME_OVERHEAD", "PROTOCOL_VERSION", "FrameError", "Message",
    "TransportError", "WireClosed", "WireTimeout", "pack_tensor",
    "recv_message", "send_message", "unpack_tensor", "RpcWorker",
    "WorkerServer", "worker_main",
]
