"""`InferenceSession` — the one supported way to run the adaptive runtime.

Port of ``repro.api.session``.  Owns the model params, one forward
executable per `ExecutionPlan`, the bandwidth observer (EWMA probe), the
profiled performance map and the adaptive policy — the paper's Fig. 1 loop
behind one object::

    session = InferenceSession.from_config(
        "llama3.2-1b", reduced=False,
        plans=[ExecutionPlan.local(), ExecutionPlan.prism_sim(L=4, cr=9.9)])
    session.profile(backend="simulated")       # offline sweep → perf map
    session.observe_bandwidth(400.0)
    logits = session.dispatch({"tokens": tokens})   # policy-routed
    out = session.generate(prompt, n_new=16)

Everything runs on ``device`` ("cuda" unless the caller asks for "cpu");
asking for the card where there is none raises.  Partitioned plans
(``voltage``, ``prism``) run SPMD: every rank of a
``repro_torch.core.seq_group`` builds the same session and calls ``run`` /
``dispatch`` with the same inputs; ``dispatch`` then takes rank 0's
decision on every rank, so all ranks enter the same collectives.
Profiling goes through the backend registry (``repro_torch.profiling``):
``simulated`` and ``trace``; ``measured`` raises until CUDA-event
profiling is ported.  The slot-pool and paged-pool serving primitives
(``init_slot_pool`` … ``paged_decode_chunk``) are what
``repro_torch.serving.ServingRuntime`` drives; they update the pools in
place.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.api.plan import ExecutionPlan
from repro_torch.core.perfmap import PerfEntry, PerfKey, PerfMap
from repro_torch.core.policy import (AdaptivePolicy, Decision, Objective,
                                     ObjectiveLike, resolve_objective)
from repro_torch.obs import MetricsRegistry
from repro_torch.utils.bandwidth import BandwidthEstimator


def resolve_device(device) -> torch.device:
    """The session's device; the card is never silently replaced by the
    CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda."
                           "is_available() is False; pass device='cpu' "
                           "to run on the CPU")
    return dev


@dataclasses.dataclass
class DispatchRecord:
    """One routed batch: what the policy decided and what actually ran."""
    batch: int
    bandwidth_mbps: float
    decision: Optional[Decision]
    wall_ms: float
    exec_key: str = ""          # executable that actually ran
    substituted: bool = False   # True when the decided key had no executable
    extrapolated: bool = False  # batch was outside the profiled grid
    codec: str = ""             # exchange codec that ran ("" = no exchange)
    wire_bytes: int = 0         # modeled bytes-on-wire this dispatch moved


@dataclasses.dataclass
class CalibrationReport:
    """What one ``session.calibrate()`` pass did to the performance map."""
    updated: int = 0                 # entries EWMA-folded
    skipped_extrapolated: int = 0    # out-of-grid batches (never folded)
    skipped_offgrid: int = 0         # in-range batches between grid points
    skipped_unprofiled: int = 0      # ran an executable with no map entry
    records: int = 0                 # dispatch records consumed
    bandwidth_updates: int = 0       # bytes/wall EWMA folds into the link
                                     # bandwidth estimate

    def __bool__(self) -> bool:
        return self.updated > 0


@dataclasses.dataclass(frozen=True)
class Explanation:
    """Why a (batch, bandwidth) pair routes the way it does — the paper's
    reported artifacts derived from the live policy."""
    batch: int
    bandwidth_mbps: float
    decision: Decision
    plan_key: str                                   # executable id chosen
    candidates: Tuple[Tuple[PerfKey, PerfEntry], ...]
    batch_crossover: Optional[int]                  # paper: 8 @ 400 Mbps
    bandwidth_crossover: Optional[float]            # paper: ≈340 Mbps @ B=8
    extrapolated: bool = False                      # batch off the grid
    codec: str = ""                                 # exchange codec chosen
    wire_bytes: int = 0                             # modeled bytes-on-wire

    def summary(self) -> str:
        lines = [f"B={self.batch} BW={self.bandwidth_mbps:g} Mbps → "
                 f"{self.decision.mode}"
                 + (f" CR={self.decision.cr:g}" if self.decision.cr else "")
                 + (f" codec={self.codec}" if self.codec else "")
                 + f"  ({self.decision.expected.per_sample_ms:.1f} ms/sample"
                 f" expected, plan {self.plan_key!r}"
                 + (f", {self.wire_bytes / 1e6:.2f} MB on wire"
                    if self.wire_bytes else "") + ")"
                 + (" [EXTRAPOLATED: batch outside the profiled grid]"
                    if self.extrapolated else "")]
        for k, e in sorted(self.candidates,
                           key=lambda kv: kv[1].per_sample_ms):
            mark = "→" if (k.mode, k.cr, k.codec) == (
                self.decision.mode, self.decision.cr,
                self.decision.codec) else " "
            label = f"{k.mode}+{k.codec}" if k.codec else k.mode
            lines.append(f"  {mark} {label:<13} CR={k.cr:<5g} "
                         f"{e.per_sample_ms:8.1f} ms/sample "
                         f"{e.per_sample_j:7.2f} J/sample")
        lines.append(f"  batch crossover @ {self.bandwidth_mbps:g} Mbps: "
                     f"{self.batch_crossover} (paper: 8)")
        lines.append(f"  bandwidth crossover @ B={self.batch}: "
                     f"{self.bandwidth_crossover} Mbps (paper: ≈340)")
        return "\n".join(lines)


class InferenceSession:
    """Facade over params + per-plan executables + profiling + policy."""

    def __init__(self, cfg, params, plans: Sequence[ExecutionPlan] = (),
                 perfmap: Optional[PerfMap] = None,
                 objective: ObjectiveLike = "latency",
                 allow_modes: Optional[Tuple[str, ...]] = None,
                 bandwidth_alpha: float = 0.3,
                 initial_bandwidth_mbps: float = 400.0,
                 temperature: float = 0.0,
                 device="cuda"):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.plans: Dict[str, ExecutionPlan] = {}
        self._execs: Dict[str, Any] = {}
        self.objective: Objective = resolve_objective(objective)
        self.temperature = temperature
        self._allow = allow_modes
        self._policy: Optional[AdaptivePolicy] = None
        self.metrics = MetricsRegistry()
        self._bwest = BandwidthEstimator(initial_bandwidth_mbps,
                                         bandwidth_alpha,
                                         metrics=self.metrics)
        self.history: List[DispatchRecord] = []
        self._serve_execs: Dict[ExecutionPlan, Dict[Tuple, Any]] = {}
        self._calibrated_upto = 0
        self.perfmap = perfmap
        for p in (plans or [ExecutionPlan.local()]):
            self.add_plan(p)

    @classmethod
    def from_config(cls, arch: str, plans: Sequence[ExecutionPlan] = (),
                    *, perfmap: Optional[PerfMap] = None, reduced=True,
                    seed: int = 0, params=None, device="cuda",
                    **kw) -> "InferenceSession":
        """Build from an architecture id (e.g. "llama3.2-1b").

        ``reduced``: True → CPU smoke-test variant; a dict → kwargs for
        ``cfg.reduced(**reduced)``; False → full-size config.  ``params``
        (e.g. from ``models.bridge.params_from_numpy``) replaces the port's
        own seeded initialisation.
        """
        from repro_torch.configs import get_config
        from repro_torch.models import registry
        dev = resolve_device(device)
        cfg = get_config(arch)
        if reduced:
            cfg = cfg.reduced(**(reduced if isinstance(reduced, dict) else {}))
        if params is None:
            params = registry.init_params(cfg, seed=seed, device=dev)
        return cls(cfg, params, plans, perfmap=perfmap, device=dev, **kw)

    # -- plans & executables -------------------------------------------------

    def add_plan(self, plan: ExecutionPlan) -> str:
        """Register a plan and its forward executable; returns its key."""
        from repro_torch.api.strategies import get_strategy
        from repro_torch.models import registry
        key = plan.key
        if key in self.plans:
            raise ValueError(f"plan {key!r} already registered")
        if (get_strategy(plan.mode).requires_L and plan.L <= 0
                and not plan.codec):
            raise ValueError(
                f"plan {key!r} has cr={plan.cr:g} but no physical L; call "
                "plan.resolve_L(n_tokens) before registering it")
        fwd = registry.forward_fn(self.cfg)
        xcfg = plan.to_exchange_config()

        @torch.inference_mode()
        def run(batch):
            return fwd(self.params, batch, xcfg)[0]

        self.plans[key] = plan
        self._execs[key] = run
        return key

    def _to_device(self, batch_inputs: Any) -> Any:
        if isinstance(batch_inputs, dict):
            return {k: torch.as_tensor(v, device=self.device)
                    for k, v in batch_inputs.items()}
        return torch.as_tensor(batch_inputs, device=self.device)

    def run(self, plan_key: str, batch_inputs: Any):
        """Run one specific plan's executable (no policy involved)."""
        if plan_key not in self._execs:
            raise KeyError(f"no executable for plan {plan_key!r}; "
                           f"registered: {sorted(self._execs)}")
        return self._execs[plan_key](self._to_device(batch_inputs))

    # -- profiling -----------------------------------------------------------

    def profile_context(self, *, hardware=None, link=None, workload=None,
                        cost_model=None, seq_len: int = 0):
        """This session's view for a profiling backend: config, params, and
        the registered plan executables."""
        from repro_torch.profiling.backends import ProfileContext
        ctx = ProfileContext(cfg=self.cfg, params=self.params,
                             plans=dict(self.plans),
                             execs=dict(self._execs),
                             workload=workload, cost_model=cost_model,
                             seq_len=seq_len)
        if hardware is not None:
            ctx.hardware = hardware
        if link is not None:
            ctx.link = link
        return ctx

    def profile(self, spec=None, *, backend: Optional[str] = None,
                hardware=None, link=None, workload=None, seq_len: int = 0,
                model=None, save_path: Optional[str] = None,
                **backend_opts) -> PerfMap:
        """Offline sweep (paper §3.3) through a registered profiling backend
        → performance map, installed on the session (and optionally saved).

        ``backend``: ``"simulated"`` (default) or ``"trace"`` (``path=`` /
        ``perfmap=``); ``"measured"`` raises ``NotImplementedError``.
        """
        from repro_torch.profiling import SweepSpec, get_backend
        if model is not None and backend in (None, "simulated"):
            backend_opts.setdefault("model", model)
        ctx = self.profile_context(hardware=hardware, link=link,
                                   workload=workload, seq_len=seq_len)
        pm = get_backend(backend or "simulated").profile(
            ctx, spec or SweepSpec(), **backend_opts)
        self.set_perfmap(pm)
        if save_path:
            pm.save(save_path)
        return pm

    def set_perfmap(self, pm: PerfMap) -> None:
        self.perfmap = pm
        self._policy = None            # rebuilt lazily against the new map

    @property
    def policy(self) -> AdaptivePolicy:
        if self.perfmap is None:
            raise RuntimeError("no performance map: call session.profile() "
                               "or pass perfmap= / set_perfmap() first")
        if self._policy is None:
            self._policy = (AdaptivePolicy(self.perfmap, self._allow)
                            if self._allow else AdaptivePolicy(self.perfmap))
        return self._policy

    # -- bandwidth observation ----------------------------------------------

    def observe_bandwidth(self, mbps: float) -> None:
        """EWMA bandwidth probe update (the caller measures the link)."""
        self._bwest.observe(mbps)

    @property
    def bandwidth(self) -> float:
        return self._bwest.mbps

    # -- adaptive dispatch ---------------------------------------------------

    def decide(self, batch: int, bandwidth_mbps: Optional[float] = None,
               objective: Optional[ObjectiveLike] = None) -> Decision:
        return self.policy.decide(batch,
                                  self.bandwidth if bandwidth_mbps is None
                                  else bandwidth_mbps,
                                  objective or self.objective)

    def plan_for_key(self, exec_key: str) -> Tuple[str, ExecutionPlan]:
        """Executable id → registered plan, with the canonical fallback
        order: exact key, then a same-mode+codec plan at another CR, then
        any same-mode plan, then any registered plan."""
        from repro_torch.api.plan import split_key
        if exec_key in self.plans:
            return exec_key, self.plans[exec_key]
        mode, _, codec = split_key(exec_key)
        for match in (lambda k: split_key(k)[::2] == (mode, codec),
                      lambda k: split_key(k)[0] == mode):
            found = next((k for k in self.plans if match(k)), None)
            if found is not None:
                return found, self.plans[found]
        if not self.plans:
            raise LookupError("no executables registered")
        key = next(iter(self.plans))
        return key, self.plans[key]

    def _exec_key_for(self, d: Decision) -> Tuple[str, bool]:
        key, _ = self.plan_for_key(d.exec_key)
        return key, key != d.exec_key

    @staticmethod
    def _input_tokens(batch_inputs: Any) -> int:
        """Token count of one request batch: dim 1 of the token input (or
        of a rank-2 array); 0 → the accounting falls back to the profiled
        workload's sequence length (images have no token dim: a ViT batch
        is charged the config's 197 tokens)."""
        lead = batch_inputs
        if isinstance(batch_inputs, dict):
            if "tokens" not in batch_inputs:
                return 0
            lead = batch_inputs["tokens"]
        shape = tuple(getattr(lead, "shape", ()))
        return int(shape[1]) if len(shape) == 2 else 0

    def _seq_group(self):
        """The seq group the partitioned plans run on in this process, if
        one is initialised (``None`` for single-process sessions)."""
        from repro_torch.core.exchange import partitioned
        from repro_torch.core.seq_group import get_seq_group, has_seq_group
        for plan in self.plans.values():
            xcfg = plan.to_exchange_config()
            if partitioned(xcfg) and has_seq_group(xcfg.seq_axis):
                return get_seq_group(xcfg.seq_axis)
        return None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def dispatch(self, batch_inputs: Any,
                 batch_size: Optional[int] = None) -> Any:
        """Route one batch per the profiled policy and run it."""
        from repro_torch.transport import plan_wire_bytes
        batch_inputs = self._to_device(batch_inputs)
        if batch_size is None:
            lead = (next(iter(batch_inputs.values()))
                    if isinstance(batch_inputs, dict) else batch_inputs)
            batch_size = int(lead.shape[0])
        d = self.decide(batch_size)
        group = self._seq_group()
        if group is not None:             # one decision for every rank
            d = group.broadcast_object(d, src=0)
        key, substituted = self._exec_key_for(d)
        plan = self.plans[key]
        self._sync()
        t0 = time.perf_counter()
        out = self._execs[key](batch_inputs)
        # wall_ms covers execution on the card, not just the enqueue
        self._sync()
        wall = (time.perf_counter() - t0) * 1e3
        wire = plan_wire_bytes(plan, self.cfg, batch_size,
                               self._input_tokens(batch_inputs))
        codec = plan.effective_codec if wire else ""
        self.history.append(DispatchRecord(
            batch_size, self.bandwidth, d, wall, exec_key=key,
            substituted=substituted, extrapolated=d.extrapolated,
            codec=codec, wire_bytes=wire))
        self.metrics.histogram("session.dispatch_ms").observe(wall)
        return out

    # -- closed-loop recalibration -------------------------------------------

    def calibrate(self, alpha: float = 0.3,
                  records: Optional[Sequence[DispatchRecord]] = None
                  ) -> CalibrationReport:
        """Fold observed dispatch wall times back into the performance map
        (EWMA per profiled entry) so the profile tracks runtime drift.

        Each uncalibrated record whose batch sits exactly on the profiled
        grid updates the entry of the executable that actually ran at the
        nearest profiled bandwidth: ``total_ms ← (1-α)·total_ms + α·wall``,
        with the decomposition and energy rescaled proportionally.
        Off-grid batches are skipped.  ``records`` overrides the session's
        own history (whose cursor is then left untouched).
        """
        if self.perfmap is None:
            raise RuntimeError("no performance map to calibrate: call "
                               "session.profile() first")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        from repro_torch.api.plan import split_key
        rep = CalibrationReport()
        table = self.policy.table(self.objective)
        own_history = records is None
        if own_history:
            records = self.history[self._calibrated_upto:]
        for rec in records:
            rep.records += 1
            if rec.extrapolated:
                rep.skipped_extrapolated += 1
                continue
            if table.nearest_batch(rec.batch) != rec.batch:
                rep.skipped_offgrid += 1
                continue
            mode, cr, codec = split_key(rec.exec_key)
            if mode == "local":
                key = PerfKey("local", rec.batch, 0.0, 0.0)
            else:
                bw = table.nearest_bandwidth(rec.bandwidth_mbps)
                if bw is None:
                    rep.skipped_unprofiled += 1
                    continue
                key = PerfKey(mode, rec.batch, cr, bw, codec)
            entry = self.perfmap.get(key)
            if entry is None and codec and mode != "local":
                # codec plans register at cr=0 but the sweep keys them at
                # the achieved ratio — fold into the unique profiled cell
                matches = [(k2, e2) for k2, e2 in self.perfmap.entries()
                           if (k2.mode, k2.batch, k2.codec,
                               k2.bandwidth_mbps) == (mode, rec.batch,
                                                      codec, bw)]
                if len(matches) == 1:
                    key, entry = matches[0]
            if entry is None or entry.total_ms <= 0:
                rep.skipped_unprofiled += 1
                continue
            # bytes-on-wire refine the link estimate: the entry's profiled
            # comm share apportions the observed wall to wire time
            if rec.wire_bytes > 0 and entry.comm_ms > 0:
                comm_wall = rec.wall_ms * entry.comm_ms / entry.total_ms
                if comm_wall > 0:
                    self._bwest.observe_transfer(rec.wire_bytes, comm_wall)
                    rep.bandwidth_updates += 1
            new_total = (1 - alpha) * entry.total_ms + alpha * rec.wall_ms
            f = new_total / entry.total_ms
            self.perfmap.put(key, dataclasses.replace(
                entry, total_ms=new_total,
                per_sample_ms=new_total / rec.batch,
                compute_ms=entry.compute_ms * f,
                staging_ms=entry.staging_ms * f,
                comm_ms=entry.comm_ms * f,
                per_sample_j=entry.per_sample_j * f,
                meta=dict(entry.meta,
                          calibrations=entry.meta.get("calibrations", 0) + 1)))
            rep.updated += 1
        if own_history:
            self._calibrated_upto = len(self.history)
        if rep.updated:
            self._policy = None        # recompile tables against new costs
        return rep

    # -- generation ----------------------------------------------------------

    def generate(self, prompt_tokens, n_new: int,
                 plan: Optional[ExecutionPlan] = None,
                 batch_extras: Optional[Dict[str, Any]] = None,
                 seed: int = 0, temperature: Optional[float] = None,
                 prefill_mode: str = "auto") -> torch.Tensor:
        """Greedy/temperature generation: prompt [B, T0] → [B, n_new]
        int32 tokens on the session's device.  ``plan`` defaults to the
        local plan (or the first registered one)."""
        from repro_torch.api import generation as gen
        plan = self._plan_or_default(plan)
        T = self.temperature if temperature is None else temperature
        return gen.generate(self.params, self._to_device(prompt_tokens),
                            n_new, self.cfg, plan.to_exchange_config(),
                            batch_extras=batch_extras, seed=seed,
                            temperature=T, prefill_mode=prefill_mode)

    # -- slot-pool serving primitives (used by repro_torch.serving) ----------

    def _plan_or_default(self, plan: Optional[ExecutionPlan]) -> ExecutionPlan:
        return (plan or self.plans.get("local")
                or next(iter(self.plans.values())))

    def _serve_exec(self, plan: ExecutionPlan, key: Tuple, build):
        """The serving function for (plan, key), built once."""
        fns = self._serve_execs.setdefault(plan, {})
        if key not in fns:
            fns[key] = build()
        return fns[key]

    def _require_slot_pool(self) -> None:
        from repro_torch.api import generation as gen
        if not gen.supports_slot_pool(self.cfg):
            raise NotImplementedError(
                f"family {self.cfg.family!r} cannot share a slot pool in the "
                f"port (supported: {gen.SLOT_POOL_FAMILIES}; the other "
                f"families are ROADMAP queue 1 item 11)")

    def init_slot_pool(self, n_slots: int, max_len: int):
        """Pooled decode cache with one slot (batch row) per in-flight
        request — the state ``prime_slot``/``decode_chunk`` operate on."""
        from repro_torch.models import transformer as tfm
        self._require_slot_pool()
        return tfm.init_decode_cache(self.cfg, n_slots, max_len,
                                     device=self.device)

    def prime_slot(self, prompt_tokens, *, total_len: int,
                   plan: Optional[ExecutionPlan] = None, seed: int = 0,
                   temperature: Optional[float] = None,
                   prefill_mode: str = "auto", with_logits: bool = False):
        """Prefill ONE request (prompt ``[1, T0]``) against a fresh cache of
        the pool's length → ``(tok0 [1,1], cache, gen)`` — exactly the
        front half of :meth:`generate`; ``gen`` is the request's generator
        (seeded from ``seed``), to be drawn from again for every sampled
        token.  ``with_logits=True`` appends the last-position logits."""
        from repro_torch.api import generation as gen
        self._require_slot_pool()
        plan = self._plan_or_default(plan)
        T = self.temperature if temperature is None else temperature
        prompt = self._to_device(prompt_tokens)
        fn = self._serve_exec(
            plan, ("prefill", int(total_len), prefill_mode, with_logits),
            lambda: gen.build_prefill_fn(self.cfg, plan.to_exchange_config(),
                                         total_len=total_len,
                                         prefill_mode=prefill_mode,
                                         with_logits=with_logits))
        return fn(self.params, prompt, {}, self.generator(seed), float(T))

    def generator(self, seed: int) -> torch.Generator:
        """A request's own generator on the session's device."""
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def admit_slot(self, pool, tok, lengths, gens, temps, request_cache,
                   slot: int, tok0, length0: int, gen0, temp0: float):
        """Slot admission (cache copy + per-slot state), in place →
        ``(pool, tok, lengths, gens, temps)``."""
        from repro_torch.api import generation as gen
        fn = self._serve_exec(None, ("admit",),
                              lambda: gen.build_admit_fn(self.cfg))
        return fn(pool, tok, lengths, gens, temps, request_cache, slot, tok0,
                  length0, gen0, temp0)

    def decode_chunk(self, pool, tok, lengths, gens, temps, *,
                     n_steps: int, plan: Optional[ExecutionPlan] = None,
                     max_len: Optional[int] = None):
        """``n_steps`` continuous-batching decode steps over every slot →
        ``(tokens [S, n_steps], pool, lengths, gens)``.  ``temps`` holds
        each slot's sampling temperature (≤0 = greedy) and ``gens`` its
        request's generator, so requests with different temperatures share
        one pool."""
        from repro_torch.api import generation as gen
        plan = self._plan_or_default(plan)
        fn = self._serve_exec(
            plan, ("chunk", int(n_steps), max_len),
            lambda: gen.build_decode_chunk_fn(
                self.cfg, plan.to_exchange_config(), n_steps=n_steps,
                max_len=max_len))
        return fn(self.params, pool, tok, lengths, gens, temps)

    # -- paged-pool serving primitives (used by repro_torch.serving.pages) ---

    def init_page_pool(self, n_pages: int, page_size: int):
        """Shared paged KV pool (``[n_layers, n_pages, page_size, Hk, dh]``
        leaves) on the session's device.  Raises for families without a
        paged decode path."""
        from repro_torch.models import transformer as tfm
        return tfm.init_page_pool(self.cfg, n_pages, page_size,
                                  device=self.device)

    def admit_paged(self, pool, tok, lengths, gens, temps, request_cache,
                    page_ids, row: int, tok0, length0: int, gen0,
                    temp0: float):
        """Paged admission: copy a primed (page-aligned) request cache into
        pool pages ``page_ids`` and set the row state, in place →
        ``(pool, tok, lengths, gens, temps)``."""
        from repro_torch.api import generation as gen
        fn = self._serve_exec(None, ("paged_admit",),
                              lambda: gen.build_paged_admit_fn(self.cfg))
        return fn(pool, tok, lengths, gens, temps, request_cache, page_ids,
                  row, tok0, length0, gen0, temp0)

    def hit_paged(self, tok, lengths, gens, temps, row: int, logits,
                  length0: int, gen0, temp0: float):
        """Full-prefix-hit admission: the first token from cached prefill
        logits with the request's own generator, and the row state →
        ``(tok, lengths, gens, temps)`` (no prefill, no cache writes)."""
        from repro_torch.api import generation as gen
        fn = self._serve_exec(None, ("paged_hit",),
                              lambda: gen.build_paged_hit_fn(self.cfg))
        return fn(tok, lengths, gens, temps, row, logits, length0, gen0,
                  temp0)

    def suffix_paged(self, pool, row_table, suffix, start_len, gen0,
                     temp0: float, *, plan: Optional[ExecutionPlan] = None):
        """Partial-prefix-hit admission: teacher-force the ``suffix``
        [1, n] prompt tail through the paged pool from position
        ``start_len`` → ``(tok0 [1,1], pool, gen, logits)``."""
        from repro_torch.api import generation as gen
        plan = self._plan_or_default(plan)
        n = int(suffix.shape[1])
        fn = self._serve_exec(
            plan, ("paged_suffix", n),
            lambda: gen.build_paged_suffix_fn(
                self.cfg, plan.to_exchange_config(), n_suffix=n))
        return fn(self.params, pool, self._to_device(row_table),
                  self._to_device(suffix), self._to_device(start_len), gen0,
                  float(temp0))

    def paged_decode_chunk(self, pool, page_table, caps, tok, lengths, gens,
                           temps, *, n_steps: int,
                           plan: Optional[ExecutionPlan] = None):
        """``n_steps`` continuous-batching decode steps over every page-
        table row → ``(tokens [S, n_steps], pool, lengths, gens)``."""
        from repro_torch.api import generation as gen
        plan = self._plan_or_default(plan)
        fn = self._serve_exec(
            plan, ("paged_chunk", int(n_steps)),
            lambda: gen.build_paged_decode_chunk_fn(
                self.cfg, plan.to_exchange_config(), n_steps=n_steps))
        return fn(self.params, pool, self._to_device(page_table),
                  self._to_device(caps), tok, lengths, gens, temps)

    # -- explanation (the paper's reported artifacts) ------------------------

    def explain(self, batch: int, bandwidth_mbps: Optional[float] = None,
                objective: Optional[ObjectiveLike] = None) -> Explanation:
        """Decision + candidate table + both crossover artifacts for one
        (batch, bandwidth) operating point."""
        from repro_torch.core.policy import PolicyTable
        from repro_torch.transport import plan_wire_bytes
        bw = self.bandwidth if bandwidth_mbps is None else bandwidth_mbps
        obj = objective or self.objective
        pol = self.policy
        d = pol.decide(batch, bw, obj)
        key, _ = self._exec_key_for(d)
        plan = self.plans[key]
        modes = tuple(sorted({k.mode for k, _ in self.perfmap.entries()}))
        cands = tuple(PolicyTable.compile(self.perfmap, modes, obj)
                      .candidates(batch, bw))
        wire = plan_wire_bytes(plan, self.cfg, batch) or d.wire_bytes
        return Explanation(
            batch=batch, bandwidth_mbps=bw, decision=d, plan_key=key,
            candidates=cands,
            batch_crossover=pol.batch_crossover(bw, obj),
            bandwidth_crossover=pol.bandwidth_crossover(batch, obj),
            extrapolated=d.extrapolated,
            codec=plan.effective_codec if plan.distributed else "",
            wire_bytes=wire)
