"""Pluggable exchange-strategy registry.

Port of ``repro.api.strategies``: each way attention can communicate
across the sequence-partition axis is one registered ``ExchangeStrategy``.
The numeric code stays in ``repro_torch.core.exchange``; a strategy binds
it together with the runtime metadata the session/policy layer needs (is it
distributed, how does the profiler name it, may the policy select it).
All four strategies are registered, so plan keys and the profiling sweep
keep their identities.  ``voltage`` and ``prism`` prefill across the ranks
of a ``repro_torch.core.seq_group``; their other codecs (ROADMAP queue 1
item 9) and the ring executor (item 7) are not ported yet.

Adding a new strategy — e.g. a top-k sparse exchange — is::

    @register_strategy
    class TopKStrategy(ExchangeStrategy):
        name = "topk"
        exchange_mode = ExchangeMode.PRISM      # or a new mode
        distributed = True
        def _prefill(self, q, k, v, cfg, **kw): ...

after which ``ExecutionPlan(mode="topk", ...)`` and the whole
``InferenceSession`` surface work unchanged.
"""
from __future__ import annotations

from typing import Dict, List, Type

from repro_torch.core import exchange as xchg
from repro_torch.core.exchange import ExchangeConfig, ExchangeMode

_REGISTRY: Dict[str, "ExchangeStrategy"] = {}


def register_strategy(cls: Type["ExchangeStrategy"]) -> Type["ExchangeStrategy"]:
    """Class decorator: instantiate and register under ``cls.name``."""
    if not getattr(cls, "name", None):
        raise ValueError(f"{cls.__name__} must define a non-empty `name`")
    if cls.name in _REGISTRY:
        raise ValueError(f"strategy {cls.name!r} already registered "
                         f"(by {type(_REGISTRY[cls.name]).__name__})")
    _REGISTRY[cls.name] = cls()
    return cls


def get_strategy(name: str) -> "ExchangeStrategy":
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown exchange strategy {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None


def list_strategies() -> List[str]:
    return sorted(_REGISTRY)


class ExchangeStrategy:
    """One way attention communicates across sequence partitions."""

    name: str = ""                             # registry key / plan.mode
    exchange_mode: ExchangeMode = ExchangeMode.LOCAL
    distributed: bool = False                  # needs >1 sequence partition
    selectable: bool = True                    # may the adaptive policy pick it
    requires_L: bool = False                   # needs segment means per shard
    default_codec: str = ""                    # repro_torch.transport codec a plan
                                               # with codec="" resolves to

    @property
    def perf_mode(self) -> str:
        """Mode name in the performance map (default: the strategy name)."""
        return self.name

    # -- plan validation ----------------------------------------------------

    def validate_plan(self, plan) -> None:
        if self.distributed and plan.seq_shards > 1 and plan.seq_axis is None:
            raise ValueError(f"{self.name} plan with seq_shards="
                             f"{plan.seq_shards} needs a seq_axis")
        if plan.codec and plan.codec != self.default_codec:
            from repro_torch.transport import CodecSpec, get_codec
            codec = get_codec(plan.codec)          # raises on unknown codec
            codec.validate_spec(CodecSpec(L=plan.L, param=plan.codec_param))
            return                    # non-default codec owns its parameters
        if self.requires_L and plan.L <= 0 and plan.cr <= 0:
            raise ValueError(f"{self.name} plan needs L > 0 or cr > 0 "
                             f"(got L={plan.L}, cr={plan.cr})")

    # -- prefill / full-sequence attention ----------------------------------

    def prefill_attention(self, q, k, v, cfg: ExchangeConfig, **kw):
        """Full-sequence attention under this exchange. Degenerate layouts
        (no sequence axis, one shard) fall back to plain local attention."""
        if (cfg.mode == ExchangeMode.LOCAL or cfg.seq_axis is None
                or cfg.seq_shards == 1):
            return xchg.local_prefill_attention(q, k, v, cfg, **kw)
        return self._prefill(q, k, v, cfg, **kw)

    def _prefill(self, q, k, v, cfg: ExchangeConfig, **kw):
        raise NotImplementedError(f"{self.name} defines no prefill exchange")

    def _require_ported(self, cfg: ExchangeConfig) -> None:
        """Raise for the exchange variants the port does not carry yet."""
        if cfg.codec and cfg.codec != self.default_codec:
            raise NotImplementedError(f"codec exchanges other than "
                                      f"{self.default_codec} are not ported "
                                      f"yet (ROADMAP queue 1 item 9)")
        if cfg.overlap_chunks > 0:
            raise NotImplementedError("the ring executor (overlap_chunks > "
                                      "0) is not ported yet (ROADMAP queue 1 "
                                      "item 7)")

    # -- decode-time attention ----------------------------------------------

    def decode_attention(self, q, k_cache, v_cache, cache_len,
                         cfg: ExchangeConfig, **kw):
        """One-token attention against a (possibly position-sharded) cache."""
        return xchg.decode_attention_sharded(q, k_cache, v_cache, cache_len,
                                             cfg, **kw)


@register_strategy
class LocalStrategy(ExchangeStrategy):
    """Single-device inference — the paper's lower-bound baseline."""
    name = "local"
    exchange_mode = ExchangeMode.LOCAL
    distributed = False


@register_strategy
class VoltageStrategy(ExchangeStrategy):
    """Full-tensor K/V exchange (Hu & Li, ICDCS'24). Profiled for reporting;
    never selected by the paper's deployment policy — it loses everywhere."""
    name = "voltage"
    exchange_mode = ExchangeMode.VOLTAGE
    distributed = True
    selectable = False
    default_codec = "identity"

    def _prefill(self, q, k, v, cfg, **kw):
        self._require_ported(cfg)
        return xchg.voltage_prefill_attention(q, k, v, cfg, **kw)


@register_strategy
class PrismStrategy(ExchangeStrategy):
    """Compressed exchange + local-exact attention.  The codec is an axis:
    the default ``segment_means`` is the paper's PRISM (scaling-aware
    softmax over remote means — byte-identical to the pre-codec path); any
    other registered codec (``int8``/``int4``/``topk``) exchanges encoded
    K/V partitions and reconstructs remote context before attention."""
    name = "prism"
    exchange_mode = ExchangeMode.PRISM
    distributed = True
    requires_L = True
    default_codec = "segment_means"

    def _prefill(self, q, k, v, cfg, **kw):
        self._require_ported(cfg)
        return xchg.prism_prefill_attention(q, k, v, cfg, **kw)


@register_strategy
class PrismSimStrategy(ExchangeStrategy):
    """PRISM math on unpartitioned tensors — single-host validation and
    training. Shares PRISM's profiling identity (same math, same cost)."""
    name = "prism_sim"
    exchange_mode = ExchangeMode.PRISM_SIM
    distributed = True
    requires_L = True
    default_codec = "segment_means"

    @property
    def perf_mode(self) -> str:
        return "prism"

    def _prefill(self, q, k, v, cfg, **kw):
        if cfg.codec and cfg.codec != self.default_codec:
            raise NotImplementedError("codec exchanges other than segment "
                                      "means are ROADMAP queue 1 item 9")
        return xchg.prism_sim_prefill_attention(q, k, v, cfg, **kw)
