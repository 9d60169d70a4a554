"""`ExecutionPlan` — the one description of *how* a batch executes.

The paper's runtime chooses between *local* execution and *distributed(CR)*
execution per batch.  Before this module, that choice was smeared over three
ad-hoc encodings: raw ``ExchangeConfig`` dataclasses (physical exchange
parameters), ``PerfKey`` strings (profiling identity), and ``"mode@cr"``
dispatcher keys (executable identity).  ``ExecutionPlan`` unifies them: it
carries mode + compression + sequence-partition layout and converts to/from
each legacy encoding.

Key identities:

* ``plan.key``   — canonical executable id, e.g. ``"local"``/``"prism@9.9"``.
  ``prism_sim`` shares the ``prism`` key family because it is PRISM math run
  on unpartitioned tensors (profiled identically).
* ``plan.to_exchange_config()`` — physical exchange parameters for model code.
* ``plan.to_perf_key(batch, bw)`` — profiling identity for the perf map.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.exchange import ExchangeConfig, ExchangeMode
from repro_torch.core.perfmap import PerfKey
from repro_torch.core.segment_means import L_to_cr, cr_to_L


def split_key(key: str) -> Tuple[str, float, str]:
    """Decompose an executable id ``"mode[@cr][+codec]"`` → (mode, cr,
    codec) — the ONE parser for the key convention (used by
    ``ExecutionPlan.parse``, ``InferenceSession.plan_for_key`` and
    ``calibrate``)."""
    mode, _, cr_s = key.partition("@")
    if cr_s:
        try:
            # a codec-less key first: "%g" can emit an exponent whose '+'
            # (e.g. "prism@1e+06") must not be read as a codec separator
            # — codec names start with a letter (enforced at registration)
            return mode, float(cr_s), ""
        except ValueError:
            pass
    base, _, codec = key.partition("+")
    mode, _, cr_s = base.partition("@")
    if cr_s:
        try:
            cr = float(cr_s)
        except ValueError:
            raise ValueError(f"malformed plan key {key!r}: compression "
                             f"rate {cr_s!r} is not a number") from None
    else:
        cr = 0.0
    return mode, cr, codec


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Mode + compression + sequence-partition layout for one executable.

    ``cr`` is the *profiled* compression rate (the perf-map label); ``L`` is
    the *physical* number of segment means per partition at the deployed
    sequence length.  They are related by ``CR = N/(L·P)`` but may be set
    independently when the smoke-test sequence length differs from the
    profiled workload's.

    ``codec`` names a registered :mod:`repro_torch.transport` codec ("" = the
    strategy's default — ``segment_means`` for prism, so pre-codec plans
    keep their identity); ``codec_param`` is its knob (quantization tile /
    top-k).  ``link`` names the transport link the cost accounting charges
    ("" = staged, the paper's GLOO path); ``overlap_chunks`` > 0 runs the
    exchange through the chunked ring executor (compute/comm overlap).
    Neither ``link`` nor ``overlap_chunks`` changes the math, so neither
    is part of the plan's identity (``key``).
    """
    mode: str = "local"              # registered strategy name
    cr: float = 0.0                  # profiled compression rate (0 = n/a)
    L: int = 0                       # segment means per partition (PRISM)
    seq_axis: Optional[str] = None   # mesh axis carrying sequence partitions
    seq_shards: int = 1              # P — number of sequence partitions
    batch_axes: Tuple[str, ...] = ()  # mesh axes sharding the batch dim
    codec: str = ""                  # exchange codec ("" = strategy default)
    codec_param: int = 0             # codec knob (quant tile / topk k)
    link: str = ""                   # transport link ("" = staged)
    overlap_chunks: int = 0          # ring-executor chunks (0 = gather)

    def __post_init__(self):
        from repro_torch.api.strategies import get_strategy
        strategy = get_strategy(self.mode)     # raises on unknown mode
        if self.codec == strategy.default_codec:
            object.__setattr__(self, "codec", "")   # canonical identity
        strategy.validate_plan(self)

    # -- identity -----------------------------------------------------------

    @property
    def perf_mode(self) -> str:
        """Mode name under which this plan is profiled ("prism" for
        prism_sim — same math, same cost model)."""
        from repro_torch.api.strategies import get_strategy
        return get_strategy(self.mode).perf_mode

    @property
    def effective_codec(self) -> str:
        """The codec that actually runs: the plan's, or the strategy's
        default ("" for strategies with no exchange payload)."""
        from repro_torch.api.strategies import get_strategy
        return self.codec or get_strategy(self.mode).default_codec

    @property
    def key(self) -> str:
        """Canonical executable id — replaces hand-rolled "mode@cr" keys."""
        base = (f"{self.perf_mode}@{self.cr:g}" if self.cr > 0
                else self.perf_mode)
        return f"{base}+{self.codec}" if self.codec else base

    @property
    def distributed(self) -> bool:
        from repro_torch.api.strategies import get_strategy
        return get_strategy(self.mode).distributed

    # -- constructors --------------------------------------------------------

    @staticmethod
    def local() -> "ExecutionPlan":
        return ExecutionPlan("local")

    @staticmethod
    def voltage(seq_axis: str = "seq", seq_shards: int = 2,
                batch_axes: Tuple[str, ...] = ()) -> "ExecutionPlan":
        return ExecutionPlan("voltage", 0.0, 0, seq_axis, seq_shards,
                             tuple(batch_axes))

    @staticmethod
    def prism(L: int, cr: float = 0.0, seq_axis: str = "seq",
              seq_shards: int = 2,
              batch_axes: Tuple[str, ...] = ()) -> "ExecutionPlan":
        return ExecutionPlan("prism", cr, L, seq_axis, seq_shards,
                             tuple(batch_axes))

    @staticmethod
    def prism_sim(L: int, cr: float = 0.0, seq_axis: str = "seq",
                  seq_shards: int = 2,
                  batch_axes: Tuple[str, ...] = ()) -> "ExecutionPlan":
        """PRISM math on unpartitioned tensors (single-host validation)."""
        return ExecutionPlan("prism_sim", cr, L, seq_axis, seq_shards,
                             tuple(batch_axes))

    @staticmethod
    def parse(key: str, *, seq_axis: str = "seq", seq_shards: int = 2,
              L: int = 0, codec_param: int = 0) -> "ExecutionPlan":
        """Parse an executable id: ``"local"`` / ``"prism@9.9"`` /
        ``"prism@4+int8"``."""
        mode, cr, codec = split_key(key)
        if mode == "local" and not codec:
            return ExecutionPlan.local()
        return ExecutionPlan(mode, cr, L, seq_axis, seq_shards,
                             codec=codec, codec_param=codec_param)

    # -- conversions ---------------------------------------------------------

    def to_exchange_config(self) -> ExchangeConfig:
        from repro_torch.api.strategies import get_strategy
        return ExchangeConfig(get_strategy(self.mode).exchange_mode,
                              self.seq_axis if self.mode != "local" else None,
                              self.seq_shards if self.mode != "local" else 1,
                              L=self.L, batch_axes=tuple(self.batch_axes),
                              strategy=self.mode, codec=self.codec,
                              codec_param=self.codec_param,
                              overlap_chunks=self.overlap_chunks)

    @staticmethod
    def from_exchange_config(xcfg: ExchangeConfig,
                             n_tokens: Optional[int] = None,
                             cr: Optional[float] = None) -> "ExecutionPlan":
        """Lift a raw ``ExchangeConfig``; ``cr`` recovered from ``n_tokens``
        via CR = N/(L·P) when not given explicitly."""
        mode = xcfg.strategy or xcfg.mode.value
        if cr is None:
            cr = (L_to_cr(n_tokens, xcfg.seq_shards, xcfg.L)
                  if (n_tokens and xcfg.L > 0 and xcfg.seq_shards > 0)
                  else 0.0)
        return ExecutionPlan(mode, cr, xcfg.L, xcfg.seq_axis,
                             xcfg.seq_shards, tuple(xcfg.batch_axes),
                             codec=xcfg.codec, codec_param=xcfg.codec_param,
                             overlap_chunks=xcfg.overlap_chunks)

    def to_perf_key(self, batch: int, bandwidth_mbps: float = 0.0) -> PerfKey:
        if not self.distributed:
            return PerfKey(self.perf_mode, batch, 0.0, 0.0)
        return PerfKey(self.perf_mode, batch, self.cr, bandwidth_mbps,
                       self.codec)

    @staticmethod
    def from_perf_key(key: PerfKey, *, seq_axis: str = "seq",
                      seq_shards: int = 2, n_tokens: Optional[int] = None,
                      simulated: bool = False,
                      codec_param: int = 0) -> "ExecutionPlan":
        """``n_tokens`` resolves the physical L from the profiled CR;
        ``simulated`` maps "prism" onto the single-host prism_sim strategy.
        Codec-bearing keys carry the codec through; parameterized codecs
        (``topk``) additionally need ``codec_param``."""
        mode = key.mode
        if mode == "local":
            return ExecutionPlan.local()
        if mode == "prism" and simulated:
            mode = "prism_sim"
        L = (cr_to_L(n_tokens, seq_shards, key.cr)
             if (n_tokens and key.cr > 0 and not key.codec) else 0)
        return ExecutionPlan(mode, key.cr, L, seq_axis, seq_shards,
                             codec=key.codec, codec_param=codec_param)

    def resolve_L(self, n_tokens: int) -> "ExecutionPlan":
        """Fill in the physical L for a deployment sequence length from the
        profiled CR (no-op for non-PRISM plans, non-default codecs, or when
        L is already set)."""
        if (self.L > 0 or self.cr <= 0 or not self.distributed
                or self.codec):
            return self
        return dataclasses.replace(
            self, L=cr_to_L(n_tokens, self.seq_shards, self.cr))

    def sharding_plan(self, mesh, cfg, *, train: bool = False,
                      decode: bool = False):
        """Mesh-level ``ShardingPlan`` for multi-rank launches (the mesh's
        axis sizes override this plan's ``seq_shards``)."""
        from repro_torch.api.strategies import get_strategy
        from repro_torch.sharding.specs import make_plan
        return make_plan(mesh, cfg, get_strategy(self.mode).exchange_mode,
                         L=self.L, train=train, decode=decode)
