"""`repro_torch.transport` — exchange-byte accounting for the port.

* :class:`ExchangeCodec` registry (``identity`` / ``segment_means``) — what
  the wire payload *is*, with exact wire-byte accounting.
* :class:`TransportLink` registry (``staged`` CPU-memory path vs ``direct``
  collective) — *how* the bytes travel, with per-stage cost accounting fed
  by the profiled :class:`~repro_torch.profiling.hardware.LinkProfile`.

:func:`exchange_cost` / :func:`plan_wire_bytes` are the accounting entry
points the profiler and the session's telemetry share.
"""
from repro_torch.transport.codecs import (CodecSpec, ExchangeCodec, get_codec,
                                          list_codecs, payload_nbytes,
                                          register_codec)
from repro_torch.transport.links import (LinkCost, TransportError,
                                         TransportLink, exchange_cost,
                                         exchange_wire_bytes, get_link,
                                         list_links, plan_wire_bytes,
                                         register_link)

__all__ = [
    "ExchangeCodec", "CodecSpec", "register_codec", "get_codec",
    "list_codecs", "payload_nbytes",
    "TransportLink", "TransportError", "LinkCost", "register_link",
    "get_link", "list_links",
    "exchange_cost", "exchange_wire_bytes", "plan_wire_bytes",
]
