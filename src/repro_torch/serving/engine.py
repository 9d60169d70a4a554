"""Serving runtime: continuous-batching decode on a slot-based KV-cache pool.

Port of ``repro.serving.engine``.  ``ServingRuntime`` is the request-level
serving loop: a bounded :class:`RequestQueue` feeds an
:class:`AdaptiveScheduler` that forms micro-batches from the compiled policy
table; admitted requests are prefilled one by one (``session.prime_slot``,
exactly ``generate``'s front half) and copied into free rows of a pooled
decode cache; decode then runs in fixed-size chunks over ALL slots, one
batched step per token with a per-slot write position — new requests are
admitted into freed slots *between* chunks and finished sequences are
evicted.  Each request samples from its own ``torch.Generator`` on the
session's device, seeded from ``Request.seed`` (where the JAX package keeps
a PRNG key per slot), so every request is token-exact with a B=1
``session.generate(prompt[None], seed=seed, temperature=T)`` of the port,
whatever shares the pool and in whatever order requests were admitted.
Greedy requests are token-exact with the JAX package too.

Fault/straggler wiring: a :class:`FaultHook` (heartbeat miss → re-admit
in-flight requests) and a :class:`StragglerHook` (observed step times →
partition rebalance proposal) plug into ``step()``, and so does the chaos
hook: with ``runtime.chaos`` set (a
:class:`~repro_torch.chaos.controller.ChaosController`), each chunk first
consumes the dispatch fault armed for ``runtime.chaos_name`` — an
injected error skips the chunk (retried next step), a straggler scales
the step time the straggler hook observes.

The JAX package's step builders, ``build_prefill_step`` and
``build_decode_step`` (its canonical jit targets for the dry run), are
here with an optional ``ShardingPlan``: on a ``("data", "model")`` mesh a
rank runs its rows of the batch (``specs.batch_shardings``) and its block
of the cache (``init_cache``), with the params held as the plan says: the
rank's ZeRO-3 blocks under a plan with ``fsdp``
(``sharding.placement.Placement.param_blocks``), each layer gathered as
the loop reaches it and freed after it (``Placement.layer_view``), else
the tree the model runs on (``Placement.held_params``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.obs import (MetricsRegistry, StatsDict, maybe_span,
                             request_trace_id)
from repro_torch.serving.queue import Request, RequestQueue
from repro_torch.serving.scheduler import (AdaptiveScheduler, FaultHook,
                                           MicroBatch, StragglerHook)

_NULL_CTX = contextlib.nullcontext()


def build_prefill_step(cfg, xcfg, plan=None) -> Callable:
    """``prefill_step(params, batch, cache) → (last-position logits [B, 1,
    V], cache with its memory primed)``: the forward that unembeds only
    the last position (``registry.prefill_fn``: the logits of the JAX
    package's whole forward at that position), then ``prefill_memory``.

    With ``plan`` (a ``ShardingPlan`` on the mesh this process joined;
    ``xcfg`` is then ``plan.xcfg``) the step is one rank's: ``batch`` is
    the global batch, of which the rank runs its rows, ``params`` the
    rank's blocks under a plan with ``fsdp`` (``Placement.param_blocks``),
    else the tree the model runs on under the plan
    (``Placement.held_params``), and ``cache`` the rank's block
    (``init_cache``); the logits are its rows'.  Under a plan that shards
    the sequence over ``model`` the forward runs the sequence over the
    row, so the split MLP blocks of the decode plan are gathered whole for
    it (``param`` bytes): all at once from held params, a layer at a time
    from blocks."""
    from repro_torch.models import registry
    from repro_torch.models import transformer as tfm
    fwd = registry.prefill_fn(cfg)
    if plan is None:
        def prefill_step(params, batch, cache):
            logits, _ = fwd(params, batch, xcfg)
            cache = tfm.prefill_memory(params, batch, cfg, xcfg, cache)
            return logits[:, -1:], cache
        return prefill_step
    on = _OnMesh(cfg, plan, full_sequence=True)

    def mesh_prefill_step(params, batch, cache):
        rows = on.rows(batch)
        if on.widen and not plan.fsdp:
            params = on.place.widened(params)
        with on.context(params) as params:
            logits, _ = fwd(params, rows, plan.xcfg)
            cache = tfm.prefill_memory(params, rows, cfg, plan.xcfg, cache)
        return logits[:, -1:], cache
    return mesh_prefill_step


def build_decode_step(cfg, xcfg, plan=None) -> Callable:
    """``serve_step(params, batch, cache, cache_index) → (logits, cache)``:
    one new token given a cache of the current length
    (``registry.decode_fn``).  With ``plan`` the step is one rank's, as
    ``build_prefill_step``'s: its rows of the global ``batch``, its block
    of the cache, and under tensor parallelism (``models.tp``: a
    ``local`` plan's heads, MLPs, experts and vocabulary, or only the MLPs
    and experts of a plan over the sequence, whose attention merges the
    cache blocks of the row) its blocks of the split weights; under a plan
    with ``fsdp`` ``params`` are the rank's blocks, each layer gathered as
    the loop reaches it."""
    from repro_torch.models import registry
    step = registry.decode_fn(cfg)
    if plan is None:
        def serve_step(params, batch, cache, cache_index):
            return step(params, batch, cache, cache_index, xcfg)
        return serve_step
    on = _OnMesh(cfg, plan, full_sequence=False)

    def mesh_serve_step(params, batch, cache, cache_index):
        with on.context(params) as params:
            return step(params, on.rows(batch), cache, cache_index,
                        plan.xcfg)
    return mesh_serve_step


def init_cache(cfg, plan, batch: int, seq: int, device=None):
    """A rank's block, under ``plan``, of the decode cache of a global
    ``batch`` × ``seq``: its rows (``batch_shardings``), its sequence block
    under a plan over the sequence, its KV heads where the heads split
    over ``model`` (a layout choice: the JAX plan leaves the heads
    replicated and GSPMD computes the attention head-sharded)."""
    from repro_torch.models import transformer as tfm
    on = _OnMesh(cfg, plan, full_sequence=False)
    with on.context(None):
        return tfm.init_decode_cache(cfg, on.n_rows(batch), seq,
                                     device=device, xcfg=plan.xcfg)


class _OnMesh:
    """One rank's part of a serving step under ``plan``: its rows of the
    batch and the tensor-parallel context of the step."""

    def __init__(self, cfg, plan, full_sequence: bool):
        from repro_torch.models import registry
        from repro_torch.sharding.placement import Placement
        self.cfg, self.plan = cfg, plan
        self.place = Placement(plan, cfg, registry.abstract_params(cfg))
        tp = self.place.tp
        # a full sequence over the row takes no split weights
        self.widen = (full_sequence and plan.seq_axis is not None
                      and tp is not None)
        self.tp = None if self.widen else tp

    def _slice(self, n: int):
        from repro_torch.sharding.specs import Shape, batch_shardings
        spec = batch_shardings(self.plan, self.cfg,
                               {"tokens": Shape((n, 1))},
                               "decode")["tokens"].spec
        if spec[0] is None:
            return slice(0, n)
        i, m = self.place._pos(spec[0])
        return slice(i * n // m, (i + 1) * n // m)

    def n_rows(self, n: int) -> int:
        s = self._slice(n)
        return s.stop - s.start

    def rows(self, batch):
        s = self._slice(next(iter(batch.values())).shape[0])
        return {k: v[s] for k, v in batch.items()}

    @contextlib.contextmanager
    def context(self, params):
        """The step's context → the tree the model runs on: ``params``
        itself, or under a plan with ``fsdp`` a ``LayerView`` of the
        rank's blocks ``params`` whose layers are gathered as the model
        reaches them (``remat.gathering``)."""
        from repro_torch.models import remat
        from repro_torch.models import tp as tpm
        with contextlib.ExitStack() as stack:
            stack.enter_context(self.place.tp_context() if self.tp is not None
                                else tpm.on_mesh(None))
            if self.plan.fsdp and params is not None:
                view = self.place.layer_view(params, whole=self.widen)
                stack.enter_context(remat.gathering(view))
                params = view.tree
            yield params


@dataclasses.dataclass
class Completion:
    """One finished request with its serving telemetry."""
    request_id: int
    tokens: np.ndarray                 # [n_new] generated token ids
    plan_key: str                      # executable family that decoded it
    arrival_ts: float
    admitted_ts: float
    finished_ts: float
    slo_ms: Optional[float] = None
    extrapolated: bool = False         # scheduled off the profiled grid
    codec: str = ""                    # exchange codec of the serving plan
    wire_bytes: int = 0                # modeled bytes-on-wire, this request
    worker: str = ""                   # serving worker, when fleet-routed

    @property
    def latency_ms(self) -> float:
        return 1e3 * (self.finished_ts - self.arrival_ts)

    @property
    def queue_ms(self) -> float:
        return 1e3 * (self.admitted_ts - self.arrival_ts)

    @property
    def slo_met(self) -> Optional[bool]:
        if self.slo_ms is None:
            return None
        return self.latency_ms <= self.slo_ms


@dataclasses.dataclass
class _Active:
    """Host-side bookkeeping for one occupied slot.

    ``first_tok`` stays a device tensor until completion — pulling it at
    admission would insert a host sync between prefill and the next decode
    chunk.  ``tokens`` holds the chunk-produced tokens (the first generated
    token is ``first_tok``, sampled by prefill)."""
    request: Request
    admitted_ts: float
    exec_key: str
    extrapolated: bool
    first_tok: Any = None                  # [1, 1] device tensor
    tokens: List[int] = dataclasses.field(default_factory=list)
    codec: str = ""                        # exchange codec of the plan
    wire_bytes: int = 0                    # modeled per-request wire bytes
    decode_start: float = 0.0              # tracer stamp: admission done

    @property
    def emitted(self) -> int:
        return 1 + len(self.tokens)

    @property
    def done(self) -> bool:
        return self.emitted >= self.request.n_new

    def token_array(self) -> np.ndarray:
        out = [int(self.first_tok.reshape(-1)[0])]
        out.extend(self.tokens[:self.request.n_new - 1])
        return np.asarray(out, np.int32)


class SlotPool:
    """One pooled decode cache + per-slot device state for one plan.

    Slot state: the pooled cache, the current token [S] and the write
    position [S] live on the device; each slot's temperature and its
    request's generator, and the request-to-slot map, on the host.
    """

    def __init__(self, session, plan, n_slots: int, max_len: int):
        self.session = session
        self.plan = plan
        self.n_slots = n_slots
        self.max_len = max_len
        self.tracer = None                 # set by ServingRuntime._pool
        self.trace_worker = ""
        self.cache = session.init_slot_pool(n_slots, max_len)
        self.tok = torch.zeros((n_slots,), dtype=torch.int32,
                               device=session.device)
        self.lengths = torch.zeros((n_slots,), dtype=torch.int32,
                                   device=session.device)
        self.gens: List[Optional[torch.Generator]] = [None] * n_slots
        self.temps: List[float] = [0.0] * n_slots
        self.slots: List[Optional[_Active]] = [None] * n_slots

    # -- occupancy -----------------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    # -- admission / eviction ------------------------------------------------

    def admit(self, req: Request, slot: int, exec_key: str,
              extrapolated: bool, now: float) -> _Active:
        """Prefill one request and scatter it into ``slot``: after this the
        slot decodes exactly like ``session.generate(prompt[None], ...)``."""
        if self.slots[slot] is not None:
            raise RuntimeError(f"slot {slot} is occupied")
        if req.total_len > self.max_len:
            raise ValueError(
                f"request needs {req.total_len} positions but the pool is "
                f"sized for {self.max_len}; raise ServingRuntime(max_len=)")
        prompt = np.asarray(req.prompt, np.int32)[None]
        with maybe_span(self.tracer, "prefill", kind="serving",
                        worker=self.trace_worker,
                        prompt_len=req.prompt_len):
            tok0, cache, gen = self.session.prime_slot(
                prompt, total_len=self.max_len, plan=self.plan,
                seed=req.seed, temperature=req.temperature)
        with maybe_span(self.tracer, "admit", kind="serving",
                        worker=self.trace_worker, slot=slot):
            (self.cache, self.tok, self.lengths, self.gens, self.temps) = \
                self.session.admit_slot(self.cache, self.tok, self.lengths,
                                        self.gens, self.temps, cache, slot,
                                        tok0, req.prompt_len, gen,
                                        req.temperature)
        from repro_torch.transport import plan_wire_bytes
        wire = plan_wire_bytes(self.plan, self.session.cfg, 1,
                               req.prompt_len)
        active = _Active(request=req, admitted_ts=now, exec_key=exec_key,
                         extrapolated=extrapolated, first_tok=tok0,
                         codec=(self.plan.effective_codec if wire else ""),
                         wire_bytes=wire)
        self.slots[slot] = active
        return active

    def evict(self, slot: int) -> _Active:
        act, self.slots[slot] = self.slots[slot], None
        return act

    def drain(self) -> List[Request]:
        """Drop every in-flight request (fault re-admission path)."""
        reqs = [s.request for s in self.slots if s is not None]
        self.slots = [None] * self.n_slots
        return reqs

    # -- decode --------------------------------------------------------------

    def decode_chunk(self, n_steps: int) -> float:
        """One chunk over all slots; appends tokens to active requests and
        returns the wall ms the chunk took (straggler signal)."""
        t0 = time.perf_counter()
        toks, self.cache, self.lengths, self.gens = \
            self.session.decode_chunk(self.cache, self.tok, self.lengths,
                                      self.gens, self.temps,
                                      n_steps=n_steps, plan=self.plan,
                                      max_len=self.max_len)
        self.tok = toks[:, -1]
        out = toks.cpu().numpy()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        for i, act in enumerate(self.slots):
            if act is None or act.done:
                continue
            need = act.request.n_new - act.emitted
            act.tokens.extend(int(t) for t in out[i, :need])
        return wall_ms


class ServingRuntime:
    """Policy-driven request serving over an :class:`InferenceSession`.

    One ``step()`` = failover check → admissions (scheduler-formed
    micro-batch into free slots) → one decode chunk per active pool →
    evictions.  ``run()`` steps until queue and pools are empty.  Each plan
    that receives traffic gets its own pool; all pools share the session's
    params.

    **Paged mode** (``page_size=``/``n_pages=``): pools become
    :class:`~repro_torch.serving.pages.PagedPool` — a budget-sized shared
    page pool instead of ``n_slots`` dense ``max_len`` rows.  Admission is then
    bounded by free *pages* (each request commits
    ``ceil(total_len/page_size)`` pages), row count defaults to
    ``n_pages`` (one-page requests can fill the whole budget), and prompts
    sharing a cached prefix skip the shared part of prefill entirely.

    Memory note (dense mode): every plan that receives traffic lazily
    allocates its own ``n_slots``-row cache pool even though global
    concurrency is capped at ``n_slots`` — with K plans in rotation the
    resident decode-cache HBM is up to K× what the admitted load can use.
    Paged mode is the budget-sized answer: pools size by pages, not by
    worst-case rows.
    """

    def __init__(self, session, *, n_slots: int = 4, chunk: int = 8,
                 max_len: int = 256, queue_size: int = 1024,
                 scheduler: Optional[AdaptiveScheduler] = None,
                 fault_hook: Optional[FaultHook] = None,
                 straggler_hook: Optional[StragglerHook] = None,
                 shed_expired: bool = False,
                 clock: Callable[[], float] = time.monotonic,
                 page_size: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 n_rows: Optional[int] = None,
                 prefix_cache: bool = True,
                 cold_horizon: Optional[int] = None,
                 cold_codec: str = "int8",
                 metrics: Optional[MetricsRegistry] = None,
                 tracer=None, worker: str = ""):
        if n_slots <= 0 or chunk <= 0:
            raise ValueError("n_slots and chunk must be >= 1")
        self.paged = page_size is not None or n_pages is not None
        if self.paged:
            # --slots stays meaningful as a *budget* alias: the dense pool
            # held n_slots·max_len positions, so that is the page budget
            self.page_size = page_size or 16
            self.n_pages = (n_pages if n_pages is not None
                            else max(1, n_slots * max_len // self.page_size))
            self.max_pages = -(-max_len // self.page_size)
            # rows bound concurrency; pages bound memory — default to one
            # row per page so short requests can fill the whole budget
            n_slots = n_rows if n_rows is not None else self.n_pages
        self.prefix_cache = prefix_cache
        self.cold_horizon = cold_horizon
        self.cold_codec = cold_codec
        self.session = session
        self.n_slots = n_slots
        self.chunk = chunk
        self.max_len = max_len
        self.queue = RequestQueue(queue_size, shed_expired=shed_expired)
        self.scheduler = scheduler or AdaptiveScheduler(session)
        self.fault_hook = fault_hook
        self.straggler_hook = straggler_hook
        self.chaos = None                 # ChaosController.attach target
        self.chaos_name = "runtime"       # fault-schedule key for this node
        # optional streaming hook: called after every decode chunk with
        # (request_id, tokens-so-far) per active request — the RPC worker
        # turns this into TokenChunk frames (repro_torch.rpc.worker)
        self.on_progress: Optional[Callable[[int, List[int]], None]] = None
        self.clock = clock
        self.pools: Dict[str, Union[SlotPool, "PagedPool"]] = {}
        self.completions: List[Completion] = []
        # observability: every scalar counter lives in the registry under
        # serving.<key>; the tracer is opt-in (None = zero-cost guards)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer
        self.trace_worker = worker
        self._req_spans: Dict[int, Any] = {}   # open per-request root spans
        self._requeue_ts: Dict[int, float] = {}
        # hot-path handles: resolved once, not per chunk/completion
        self._chunk_hist = self.metrics.histogram("serving.chunk_ms")
        self._latency_hist = self.metrics.histogram(
            "serving.request_latency_ms")
        self.stats = StatsDict(
            self.metrics, "serving",
            {"steps": 0, "chunks": 0, "admitted": 0,
             "requeued": 0, "max_concurrent": 0, "retries": 0,
             "straggled": 0,
             "wire_bytes": 0},      # modeled bytes-on-wire admitted
            labels={"worker": worker} if worker else None)

    # -- request intake ------------------------------------------------------

    def submit(self, prompt, n_new: int, *, slo_ms: Optional[float] = None,
               seed: int = 0, temperature: float = 0.0) -> Request:
        return self.submit_request(
            Request(prompt=np.asarray(prompt), n_new=n_new, slo_ms=slo_ms,
                    seed=seed, temperature=temperature,
                    arrival_ts=self.clock()))

    def submit_request(self, req: Request) -> Request:
        if req.total_len > self.max_len:
            raise ValueError(
                f"request needs {req.total_len} positions but max_len is "
                f"{self.max_len}")
        return self.queue.put(req)

    # -- plan / pool resolution ----------------------------------------------

    def _pool(self, exec_key: str) -> Union[SlotPool, "PagedPool"]:
        key, plan = self.session.plan_for_key(exec_key)
        pool = self.pools.get(key)
        if pool is None:
            if self.paged:
                from repro_torch.serving.pages import PagedPool
                pool = PagedPool(self.session, plan, self.n_slots,
                                 n_pages=self.n_pages,
                                 page_size=self.page_size,
                                 max_pages=self.max_pages,
                                 prefix_cache=self.prefix_cache,
                                 cold_horizon=self.cold_horizon,
                                 cold_codec=self.cold_codec)
            else:
                pool = SlotPool(self.session, plan, self.n_slots,
                                self.max_len)
            self.pools[key] = pool
        pool.tracer = self.tracer        # may be attached after pools exist
        pool.trace_worker = self.trace_worker
        return pool

    def _run_trace(self) -> str:
        """Trace id for runtime-level spans (decode chunks, failovers) that
        belong to no single request."""
        return f"runtime:{self.trace_worker or 'serving'}"

    def _free_slots(self) -> int:
        used = sum(p.n_active for p in self.pools.values())
        # pools share the slot budget conceptually; a fresh plan's pool
        # allocates lazily, so "free" is the budget minus what is in flight
        return max(self.n_slots - used, 0)

    @property
    def idle(self) -> bool:
        """True when no request is in flight in any pool."""
        return all(p.n_active == 0 for p in self.pools.values())

    # -- telemetry -----------------------------------------------------------

    def stats_snapshot(self) -> Dict[str, Any]:
        """Consistent point-in-time copy of the runtime counters.

        ``stats`` is a plain mutable dict updated mid-``step()``; a reader
        in another logical context (the fleet router, a benchmark thread)
        must not see half-updated state or hold a reference that keeps
        mutating under it.  The snapshot also folds in derived gauges —
        queue depth, in-flight count, completions, and the queue's shed
        accounting (rejected puts by reason).
        """
        snap = dict(self.stats)
        snap["queue_depth"] = len(self.queue)
        snap["in_flight"] = sum(p.n_active for p in self.pools.values())
        snap["completed"] = len(self.completions)
        snap["rejected"] = self.queue.rejected
        snap["rejections"] = dict(self.queue.rejections)
        snap["expired"] = self.queue.rejections.get("expired", 0)
        snap["failovers"] = (len(self.fault_hook.events)
                             if self.fault_hook is not None else 0)
        if self.paged:
            agg: Dict[str, Any] = {
                "pages_total": 0, "pages_free": 0, "pages_committed": 0,
                "prefix_hits": 0, "prefix_misses": 0, "full_hits": 0,
                "partial_hits": 0, "cow_splits": 0, "cold_pages": 0,
                "dequant_pages": 0, "prefix_entries": 0,
                "prefix_evictions": 0}
            for p in self.pools.values():
                for k, v in p.page_stats().items():
                    if k in agg:
                        agg[k] += v
            snap.update(agg)
            snap["page_occupancy"] = (
                1.0 - agg["pages_free"] / agg["pages_total"]
                if agg["pages_total"] else 0.0)
            looked = agg["prefix_hits"] + agg["prefix_misses"]
            snap["prefix_hit_rate"] = (agg["prefix_hits"] / looked
                                       if looked else 0.0)
        return snap

    # -- fleet support -------------------------------------------------------

    def drain_requests(self) -> List[Request]:
        """Pull every queued AND in-flight request out of this runtime
        (dead-worker path: the fleet router re-routes them to surviving
        workers).  Deadline order is recovered by the target queue's EDF
        ``pop``; re-served requests stay token-exact because ``seed``/
        ``temperature`` pin the sampling chain."""
        reqs = self.queue.drain()
        for pool in self.pools.values():
            reqs.extend(pool.drain())
        return reqs

    # -- the serving loop ----------------------------------------------------

    def step(self) -> List[Completion]:
        """One scheduling + decode round; returns completions it produced."""
        self.stats["steps"] += 1
        now = self.clock()
        self._check_faults(now)
        self._admit(now)
        done: List[Completion] = []
        tr = self.tracer
        for key, pool in self.pools.items():
            if pool.n_active == 0:
                continue
            straggle = 1.0
            if self.chaos is not None:
                fault = self.chaos.dispatch_fault(self.chaos_name, now)
                if fault is not None and fault.kind == "error":
                    # the chunk's exchange failed before any token was
                    # committed: nothing to roll back, retry next step
                    self.stats["retries"] += 1
                    if tr is not None:
                        tr.record("retry", start=now, end=now,
                                  kind="serving", trace_id=self._run_trace(),
                                  worker=self.trace_worker, plan=key,
                                  reason="chaos_error")
                    continue
                if fault is not None and fault.kind == "straggle":
                    straggle = max(fault.value, 1.0)
                    self.stats["straggled"] += 1
            t0 = self.clock()
            wall_ms = pool.decode_chunk(self.chunk)
            self.stats["chunks"] += 1
            self._observe_stragglers(pool, wall_ms * straggle)
            if self.on_progress is not None:
                for act in pool.slots:
                    if act is not None:
                        self.on_progress(act.request.id, act.tokens)
            fin = self.clock()
            if tr is not None:
                tr.record("decode_chunk", start=t0, end=fin, kind="serving",
                          trace_id=self._run_trace(),
                          worker=self.trace_worker, plan=key,
                          active=pool.n_active, steps=self.chunk)
                self._chunk_hist.observe(wall_ms)
            for i, act in enumerate(pool.slots):
                if act is not None and act.done:
                    pool.evict(i)
                    done.append(Completion(
                        request_id=act.request.id,
                        tokens=act.token_array(),
                        plan_key=key, arrival_ts=act.request.arrival_ts,
                        admitted_ts=act.admitted_ts, finished_ts=fin,
                        slo_ms=act.request.slo_ms,
                        extrapolated=act.extrapolated,
                        codec=act.codec, wire_bytes=act.wire_bytes))
                    if tr is not None:
                        self._finish_request(act, fin)
        self.completions.extend(done)
        return done

    def _finish_request(self, act: _Active, fin: float) -> None:
        """Close a finished request's trace: one ``decode`` residency leaf
        (admission-complete → finished) plus the root ``request`` span."""
        req = act.request
        root = self._req_spans.pop(req.id, None)
        tid = req.trace_id or request_trace_id(req.id)
        self.tracer.record(
            "decode", start=act.decode_start or act.admitted_ts,
            end=fin, kind="serving", trace_id=tid,
            parent_id=root.span_id if root is not None else None,
            worker=self.trace_worker, tokens=req.n_new)
        if root is not None:
            self.tracer.finish(root, at=fin)
        self._latency_hist.observe(1e3 * (fin - req.arrival_ts))

    def run(self, max_steps: int = 100_000) -> List[Completion]:
        """Serve until the queue and every pool are empty."""
        start = len(self.completions)
        steps = 0
        while (self.queue or not self.idle):
            self.step()
            steps += 1
            if steps >= max_steps:
                raise RuntimeError(f"run() exceeded {max_steps} steps")
        return self.completions[start:]

    def drive(self, prompts: Sequence, arrivals: Sequence[float], n_new,
              *, seeds: Optional[Sequence[int]] = None,
              slo_ms: Optional[float] = None,
              temperatures: Optional[Sequence[float]] = None,
              poll_s: float = 0.005) -> List[Completion]:
        """Replay a real-time arrival schedule: submit request ``i`` once
        ``arrivals[i]`` seconds have elapsed (``clock``-relative), stepping
        the runtime in between and sleeping only when there is nothing to
        do.  ``n_new`` is an int or a per-request sequence.  Returns the
        completions this drive produced — the one arrival loop shared by
        ``launch/serve.py`` and ``benchmarks/serve_throughput.py``."""
        start = len(self.completions)
        t0 = self.clock()
        pending = list(range(len(prompts)))
        while pending or self.queue or not self.idle:
            now = self.clock() - t0
            while pending and arrivals[pending[0]] <= now:
                if len(self.queue) >= self.queue.max_size:
                    break      # backpressure: resubmit after the next step
                i = pending.pop(0)
                self.submit(
                    prompts[i],
                    n_new[i] if not isinstance(n_new, int) else n_new,
                    seed=seeds[i] if seeds is not None else i,
                    slo_ms=slo_ms,
                    temperature=(temperatures[i] if temperatures is not None
                                 else 0.0))
            if self.queue or not self.idle:
                self.step()
            elif pending:
                time.sleep(min(max(arrivals[pending[0]] - now, 0.0),
                               poll_s))
        return self.completions[start:]

    # -- admission -----------------------------------------------------------

    def _request_root(self, req: Request):
        """Open (or reuse, on re-admission after a fault) the per-request
        root span.  ``req.parent_span`` — set by a fleet router or carried
        over the RPC wire — parents the whole tree under the client's
        dispatch span."""
        if not req.trace_id:
            req.trace_id = request_trace_id(req.id)
        root = self._req_spans.get(req.id)
        if root is None:
            root = self.tracer.start(
                "request", kind="serving", trace_id=req.trace_id,
                parent_id=req.parent_span or None,
                worker=self.trace_worker, at=req.arrival_ts,
                n_new=req.n_new, prompt_len=req.prompt_len)
            self._req_spans[req.id] = root
        return root

    def _page_feasible(self) -> int:
        """How many queue-head requests (EDF order) the paged pool could
        commit pages for right now — the admission bound the scheduler
        sees instead of raw free rows."""
        if not self.pools:
            return self.n_slots           # first pool allocates fresh/empty
        avail = max(p.alloc.available()
                    + (p.prefix.reclaimable() if p.prefix is not None else 0)
                    for p in self.pools.values())
        k = 0
        for req in sorted(self.queue,
                          key=lambda r: (r.deadline(), r.arrival_ts)):
            need = -(-req.total_len // self.page_size)
            if need > avail:
                break
            avail -= need
            k += 1
        return k

    def _admit(self, now: float) -> Optional[MicroBatch]:
        free = self._free_slots()
        if self.paged:
            # admit against free *pages*, not free rows: the policy table's
            # plan_batch sees only what the page budget can commit to
            free = min(free, self._page_feasible())
        mb = self.scheduler.next_batch(self.queue, free, idle=self.idle,
                                       now=now)
        if mb is None:
            return None
        pool = self._pool(mb.exec_key)
        free_ids = pool.free_slots()
        tr = self.tracer
        for req, slot in zip(mb.requests, free_ids):
            if self.paged and not pool.can_admit(req):
                # feasibility was estimated across pools / before this
                # micro-batch's own commitments — recheck per request
                self.queue.put(req, force=True)
                self._requeue_ts[req.id] = now
                self.stats["requeued"] += 1
                continue
            root = None
            if tr is not None:
                root = self._request_root(req)
                # end at *this* request's admission start, not the admit
                # pass entry: earlier requests' prefills in the same pass
                # are still queueing time for this one
                tr.record("queue_wait",
                          start=self._requeue_ts.pop(req.id,
                                                     req.arrival_ts),
                          end=tr.clock(), kind="serving",
                          trace_id=req.trace_id,
                          parent_id=root.span_id, worker=self.trace_worker)
            with tr.active(root) if tr is not None else _NULL_CTX:
                act = pool.admit(req, slot, mb.exec_key, mb.extrapolated,
                                 now)
            if tr is not None:
                act.decode_start = tr.clock()
            self.stats["admitted"] += 1
            self.stats["wire_bytes"] += act.wire_bytes
        overflow = mb.requests[len(free_ids):]
        for req in overflow:               # should not happen; be safe
            self.queue.put(req, force=True)
            self._requeue_ts[req.id] = now
        self.stats["max_concurrent"] = max(
            self.stats["max_concurrent"],
            sum(p.n_active for p in self.pools.values()))
        return mb

    # -- hooks ---------------------------------------------------------------

    def heartbeat(self, node: str) -> None:
        if self.fault_hook is not None:
            self.fault_hook.beat(node)

    def _check_faults(self, now: Optional[float] = None) -> None:
        if self.fault_hook is None:
            return
        dead = self.fault_hook.check()
        if not dead:
            return
        now = self.clock() if now is None else now
        requeued = 0
        for pool in self.pools.values():
            for req in pool.drain():       # re-admit from scratch; these
                # were already admitted once — the bound must not drop them
                self.queue.put(req, force=True)
                self._requeue_ts[req.id] = now
                requeued += 1
        self.stats["requeued"] += requeued
        self.fault_hook.record(dead, requeued)
        if self.tracer is not None:
            self.tracer.record("failover", start=now, end=now,
                               kind="serving", trace_id=self._run_trace(),
                               worker=self.trace_worker,
                               dead=",".join(sorted(dead)),
                               requeued=requeued)

    def _observe_stragglers(self, pool: SlotPool, wall_ms: float) -> None:
        if self.straggler_hook is None:
            return
        # chunk walls are telemetry only — genuinely per-device step times
        # must come from the fleet via hook.observe(times, n_tokens=...)
        self.straggler_hook.observe_chunk(wall_ms, self.chunk)
