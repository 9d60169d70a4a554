"""`repro_torch.transport` — exchange codecs, staged-link transport and
the exchange executors.

* :class:`ExchangeCodec` registry (``identity`` / ``segment_means`` /
  ``int8`` / ``int4`` / ``topk``) — what the wire payload *is*, with exact
  wire-byte accounting (``@register_codec`` to add your own); measured
  decode throughputs through :func:`calibrate_codec_bws`.
* :class:`TransportLink` registry (``staged`` CPU-memory path vs ``direct``
  collective) — *how* the bytes travel, with per-stage cost accounting fed
  by the profiled :class:`~repro_torch.profiling.hardware.LinkProfile`.
* the exchange executors: the ring exchange overlapped with attention
  (:func:`ring_prefill_attention`), the codec exchange
  (:func:`codec_prefill_attention`) and its single-host form.

:func:`exchange_cost` / :func:`plan_wire_bytes` are the accounting entry
points the profiler and the session's telemetry share.
"""
from repro_torch.transport.codecs import (CodecSpec, ExchangeCodec,
                                          calibrate_codec_bws,
                                          codec_overrides, get_codec,
                                          list_codecs, measure_decode_bw,
                                          payload_nbytes, register_codec)
from repro_torch.transport.executor import (codec_prefill_attention,
                                            codec_sim_attention,
                                            codec_sim_prefill_attention,
                                            ring_prefill_attention)
from repro_torch.transport.links import (LinkCost, TransportError,
                                         TransportLink, exchange_cost,
                                         exchange_wire_bytes, get_link,
                                         list_links, plan_wire_bytes,
                                         register_link)

__all__ = [
    "ExchangeCodec", "CodecSpec", "register_codec", "get_codec",
    "list_codecs", "payload_nbytes", "measure_decode_bw",
    "calibrate_codec_bws", "codec_overrides",
    "TransportLink", "TransportError", "LinkCost", "register_link",
    "get_link", "list_links",
    "exchange_cost", "exchange_wire_bytes", "plan_wire_bytes",
    "ring_prefill_attention", "codec_prefill_attention",
    "codec_sim_attention", "codec_sim_prefill_attention",
]
