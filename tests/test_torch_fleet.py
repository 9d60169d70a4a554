"""The port's fleet tier on the CPU (``repro_torch.fleet``), mirroring the
JAX package's ``tests/test_fleet.py``: registry liveness, policy-table
placement, backpressure, virtual-time failover, codec calibration (on the
CPU here), and real ``WorkerHandle`` workers failing over token-exact.
Against the JAX package: the same seeded SimWorker fleet gives the same
placement records, and a real two-worker fleet on the same f32 weights
the same tokens across a kill."""
import numpy as np
import pytest


from repro_torch.api import ExecutionPlan, InferenceSession
from repro_torch.fleet import (DeviceRegistry, FleetRejected, FleetRouter,
                         SimWorker, WorkerHandle, scaled_hardware)
from repro_torch.profiling import ProfileContext, SweepSpec, get_backend
from repro_torch.profiling.hardware import JETSON_ORIN_NANO
from repro_torch.serving.queue import Request


def _prompt(T0, seed=0):
    return np.random.RandomState(seed).randint(0, 64, T0)


# one simulated sweep per hardware speed grade, shared across tests
_PM_CACHE = {}


def _sim_worker(name, factor=1.0, **kw):
    if factor not in _PM_CACHE:
        hw = scaled_hardware(JETSON_ORIN_NANO, factor)
        pm = get_backend("simulated").profile(ProfileContext(hardware=hw),
                                              SweepSpec())
        _PM_CACHE[factor] = (hw, pm)
    hw, pm = _PM_CACHE[factor]
    return SimWorker(name, perfmap=pm, hardware=hw, **kw)


@pytest.fixture(scope="module")
def sessions():
    """Two real sessions with IDENTICAL params (same config, same seed) —
    the fleet failover contract: a re-routed request is token-exact on any
    worker."""
    def make():
        s = InferenceSession.from_config(
            "llama3.2-1b", reduced={"vocab_size": 64}, device="cpu",
            plans=[ExecutionPlan.local(),
                   ExecutionPlan.prism_sim(L=4, cr=9.9)])
        s.profile(backend="simulated")
        return s
    return make(), make()


# --- registry ----------------------------------------------------------------

def test_registry_liveness_and_consume():
    t = [0.0]
    reg = DeviceRegistry(heartbeat_timeout_s=5.0, clock=lambda: t[0])
    reg.add(_sim_worker("a"))
    reg.add(_sim_worker("b"))
    assert reg.names == ["a", "b"] and len(reg) == 2
    t[0] = 4.0
    reg.beat("a")
    t[0] = 7.0                            # b missed its deadline
    assert reg.is_alive("a") and not reg.is_alive("b")
    assert [w.name for w in reg.alive()] == ["a"]
    assert reg.check_dead() == ["b"]      # reported exactly once
    assert reg.check_dead() == []
    assert reg.dead() == ["b"]
    reg.revive("b")
    assert reg.is_alive("b")
    reg.fail("b")                         # explicit kill wins over beats
    reg.beat("b")
    assert not reg.is_alive("b")
    with pytest.raises(ValueError, match="already registered"):
        reg.add(_sim_worker("a"))
    with pytest.raises(KeyError, match="unknown worker"):
        reg.get("nope")
    with pytest.raises(KeyError):
        reg.fail("nope")
    reg.remove("a")
    assert reg.names == ["b"]


def test_scaled_hardware():
    hw = scaled_hardware(JETSON_ORIN_NANO, 0.5, name="half")
    assert hw.name == "half"
    assert hw.eff_inf == pytest.approx(JETSON_ORIN_NANO.eff_inf * 0.5)
    assert hw.eff_slope == pytest.approx(JETSON_ORIN_NANO.eff_slope * 0.5)
    # board-level constants are not speed-scaled
    assert hw.launch_overhead_ms == JETSON_ORIN_NANO.launch_overhead_ms
    with pytest.raises(ValueError):
        scaled_hardware(JETSON_ORIN_NANO, 0.0)


# --- placement scoring -------------------------------------------------------

def test_placement_prefers_faster_hardware():
    reg = DeviceRegistry(heartbeat_timeout_s=1e9)
    reg.add(_sim_worker("slow", 0.35))
    reg.add(_sim_worker("fast", 1.0))
    router = FleetRouter(reg)
    ranked = router.rank()
    assert [s.worker for s in ranked] == ["fast", "slow"]
    # the score IS the per-worker table cost (no queue pressure yet) —
    # placement is explainable down to the profiled cell
    assert ranked[0].score == pytest.approx(ranked[0].per_request_cost)
    assert ranked[0].per_request_cost < ranked[1].per_request_cost
    rec = router.route(Request(_prompt(4), 8))
    assert rec.worker == "fast"
    text = rec.explain()
    assert "fast" in text and "score" in text and "table" in text


def test_placement_steers_by_queue_depth():
    """Queue pressure must eventually beat a hardware advantage: with the
    fast worker loaded up, new requests go to the slower empty one."""
    reg = DeviceRegistry(heartbeat_timeout_s=1e9)
    fast = reg.add(_sim_worker("fast", 1.0, n_slots=2, queue_size=32))
    slow = reg.add(_sim_worker("slow", 0.6, n_slots=2, queue_size=32))
    router = FleetRouter(reg)
    for i in range(10):
        router.route(Request(_prompt(4, seed=i), 8, seed=i))
    assert fast.pending > 0 and slow.pending > 0     # both share the load
    # and the fast worker carries more of it
    assert fast.pending >= slow.pending


# --- backpressure ------------------------------------------------------------

def test_backpressure_rejected_with_reason():
    reg = DeviceRegistry(heartbeat_timeout_s=1e9)
    a = reg.add(_sim_worker("a", queue_size=2))
    b = reg.add(_sim_worker("b", queue_size=2))
    router = FleetRouter(reg)
    for i in range(4):                    # fill both bounded queues
        router.route(Request(_prompt(4, seed=i), 8))
    with pytest.raises(FleetRejected) as ei:
        router.route(Request(_prompt(4), 8))
    assert ei.value.reason == "all_full"
    assert router.stats["rejected"] == 1
    assert router.stats["rejections"] == {"all_full": 1}
    # each worker's queue counted its own refusal (visible in telemetry)
    assert a.queue.rejections["full"] >= 1
    assert b.queue.rejections["full"] >= 1
    with pytest.raises(FleetRejected) as ei:
        router.route(Request(_prompt(4), 8), pin="a")
    assert ei.value.reason == "full"
    # the re-route path bypasses the bound: admitted work is never shed
    rec = router.route(Request(_prompt(4), 8), force=True)
    assert rec.worker in ("a", "b")
    reg.fail("a")
    reg.check_dead()
    with pytest.raises(FleetRejected) as ei:
        router.route(Request(_prompt(4), 8), pin="a")
    assert ei.value.reason == "dead_worker"
    assert a.queue.rejections["dead_worker"] == 1
    assert router.stats["rejections"]["dead_worker"] == 1
    reg.fail("b")
    reg.check_dead()
    with pytest.raises(FleetRejected) as ei:
        router.route(Request(_prompt(4), 8))
    assert ei.value.reason == "no_workers"


# --- failover (virtual) ------------------------------------------------------

def test_virtual_failover_reroutes_in_edf_order():
    """Heartbeat-miss requeue must preserve EDF deadline ordering: the dead
    worker's drained requests are re-served tightest-deadline-first on the
    survivor, regardless of their arrival order."""
    reg = DeviceRegistry(heartbeat_timeout_s=1e9)
    reg.add(_sim_worker("a", n_slots=1, queue_size=16))
    dead = reg.add(_sim_worker("b", n_slots=1, queue_size=16))
    router = FleetRouter(reg)
    slos = [4000.0, 1000.0, None, 2000.0]     # arrival order != EDF order
    reqs = [Request(_prompt(4, seed=i), 8, slo_ms=s, arrival_ts=0.0)
            for i, s in enumerate(slos)]
    for r in reqs:
        router.route(r, pin="b")
    assert dead.pending == 4
    out = router.drive_virtual(
        [], events=[(0.0, lambda: reg.fail("b"))])
    comps = out["completions"]
    assert len(comps) == 4 and all(c.worker == "a" for c in comps)
    edf = [r.id for r in sorted(reqs,
                                key=lambda r: (r.deadline(), r.arrival_ts))]
    assert [c.request_id for c in comps] == edf
    # failover telemetry: one event, every request re-placed once
    assert router.stats["rerouted"] == 4 and router.stats["lost"] == 0
    assert [e.dead for e in router.events] == [["b"]]
    assert router.events[0].requeued == 4
    for r in reqs:
        recs = router.placement_for(r.id)
        assert [p.reason for p in recs] == ["pinned", "rerouted"]
        assert recs[-1].worker == "a"


def test_virtual_fleet_beats_best_single():
    """The tentpole claim in miniature: routed heterogeneous workers beat
    the best single worker's aggregate tok/s under the same Poisson load
    (the full gated run lives in benchmarks/fleet_throughput.py)."""
    rng = np.random.RandomState(0)
    arrivals = np.cumsum(rng.exponential(1 / 40.0, 30))
    trace = [(float(arrivals[i]), _prompt(8, seed=i)) for i in range(30)]

    def tok_s(factors):
        reg = DeviceRegistry(heartbeat_timeout_s=1e9)
        for j, f in enumerate(factors):
            reg.add(_sim_worker(f"w{j}-{f:g}", f, queue_size=8))
        router = FleetRouter(reg)
        out = router.drive_virtual(
            [Request(prompt=p, n_new=16, seed=i, arrival_ts=t)
             for i, (t, p) in enumerate(trace)])
        return out["served_tokens"] / out["makespan_s"]

    fleet = tok_s([1.0, 0.6, 0.35])
    best_single = max(tok_s([1.0]), tok_s([0.6]), tok_s([0.35]))
    assert fleet > 1.2 * best_single


# --- measured codec decode throughput ---------------------------------------

def test_codec_calibration_measures_and_feeds_cost():
    from repro_torch.transport import (calibrate_codec_bws, exchange_cost,
                                 get_codec, measure_decode_bw)
    from repro_torch.profiling.hardware import WIFI_GLOO
    names = ("int8", "int4", "topk")
    assert all(not get_codec(n).decode_bw_measured for n in names)
    kw = dict(n_tokens=64, d_model=64, bytes_per_el=4, batch=2, P=2,
              n_layers=2, bandwidth_mbps=400.0, profile=WIFI_GLOO)
    before = exchange_cost("int8", **kw)
    try:
        out = calibrate_codec_bws(shape=(2, 16, 64), iters=2, warmup=1,
                                  device="cpu")
        # measures exactly the codecs that model a reconstruction cost
        assert set(out) == set(names)
        for n, bw in out.items():
            c = get_codec(n)
            assert bw > 0 and c.decode_bw == bw and c.decode_bw_measured
        # summarizing / free codecs are never measured
        assert not get_codec("segment_means").decode_bw_measured
        assert not get_codec("identity").decode_bw_measured
        assert calibrate_codec_bws(names=["segment_means"], device="cpu") == {}
        # cached: a second sweep reuses the measurement
        assert calibrate_codec_bws(shape=(2, 16, 64), device="cpu") == out
        # the measured value feeds cost accounting live (decode_ms scales
        # as 1/decode_bw) — and therefore any policy sweep run after
        # calibration
        after = exchange_cost("int8", **kw)
        assert after["decode_ms"] == pytest.approx(
            before["decode_ms"] * 8e8 / out["int8"])
        # force re-measures rather than reusing the cache
        forced = calibrate_codec_bws(names=["topk"], force=True,
                                     shape=(2, 16, 64), iters=2, warmup=1,
                                     device="cpu")
        assert forced["topk"] > 0
    finally:
        for n in names:                    # restore the class constants
            c = get_codec(n)
            c.__dict__.pop("decode_bw", None)
            c.__dict__.pop("decode_bw_measured", None)
    assert get_codec("int8").decode_bw == 8e8
    restored = exchange_cost("int8", **kw)
    assert restored["decode_ms"] == pytest.approx(before["decode_ms"])
    # direct measurement of a summarizing codec is still possible (it has
    # a decode, it's just never reconstructed in serving)
    bw = measure_decode_bw(get_codec("int8"), shape=(2, 8, 32), iters=1,
                           warmup=1, device="cpu")
    assert bw > 0


def test_registry_codec_calibration_hook():
    from repro_torch.transport import get_codec
    try:
        reg = DeviceRegistry(heartbeat_timeout_s=1e9,
                             calibrate_codecs=True, device="cpu")
        assert set(reg.codec_bws) == {"int8", "int4", "topk"}
        assert get_codec("int8").decode_bw == reg.codec_bws["int8"]
    finally:
        for n in ("int8", "int4", "topk"):
            c = get_codec(n)
            c.__dict__.pop("decode_bw", None)
            c.__dict__.pop("decode_bw_measured", None)


# --- real workers: fan-out + token-exact failover ----------------------------

def test_fanout_token_exact_across_workers(sessions):
    s1, s2 = sessions
    reg = DeviceRegistry(heartbeat_timeout_s=1e9)
    reg.add(WorkerHandle("w1", s1, n_slots=2, chunk=3, max_len=24))
    reg.add(WorkerHandle("w2", s2, n_slots=2, chunk=3, max_len=24))
    router = FleetRouter(reg)
    prompts = [_prompt(4, seed=i) for i in range(4)]
    placed = router.fanout(prompts, 6)
    assert all(rec is not None for _, rec in placed)
    # equal hardware: queue pressure spreads the fan-out over both workers
    assert {rec.worker for _, rec in placed} == {"w1", "w2"}
    router.run()
    for req, rec in placed:
        comp = router.completion_for(req.id)
        assert comp is not None
        ref = s1.generate(np.asarray(req.prompt)[None], req.n_new,
                          seed=req.seed)
        np.testing.assert_array_equal(comp.tokens, np.asarray(ref)[0])


def test_failover_midstream_token_exact(sessions):
    """Killing a worker mid-decode re-routes its queued AND in-flight
    requests to the survivor, token-exact vs ``session.generate`` — the
    fleet-level acceptance criterion."""
    s1, s2 = sessions
    reg = DeviceRegistry(heartbeat_timeout_s=1e9)
    reg.add(WorkerHandle("w1", s1, n_slots=2, chunk=3, max_len=24))
    w2 = reg.add(WorkerHandle("w2", s2, n_slots=2, chunk=3, max_len=24))
    router = FleetRouter(reg)
    reqs = [router.submit(_prompt(4, seed=i), 6, pin="w1", seed=i)[0]
            for i in range(3)]            # 2 in flight + 1 queued on w1
    reqs.append(router.submit(_prompt(4, seed=9), 6, pin="w2", seed=9)[0])
    router.step()                         # both workers decode a chunk
    reg.fail("w1")                        # heartbeat miss mid-decode
    router.run()
    assert router.stats["rerouted"] == 3 and router.stats["lost"] == 0
    assert [e.dead for e in router.events] == [["w1"]]
    assert router.registry.dead() == ["w1"]
    for req in reqs:
        comp = router.completion_for(req.id)
        assert comp is not None
        ref = s2.generate(np.asarray(req.prompt)[None], req.n_new,
                          seed=req.seed)
        np.testing.assert_array_equal(comp.tokens, np.asarray(ref)[0])
    for req in reqs[:3]:
        recs = router.placement_for(req.id)
        assert [p.reason for p in recs] == ["pinned", "rerouted"]
        assert recs[-1].worker == "w2"
    # the dead worker's shed accounting is visible fleet-wide
    snap = router.stats_snapshot()
    assert snap["dead"] == ["w1"] and snap["alive"] == ["w2"]
    assert snap["workers"]["w2"]["completed"] == len(w2.completions) == 4


# --- calibration provenance --------------------------------------------------

def test_calibration_provenance_measured_vs_estimated():
    """A worker that can measure codec throughput on its own process wins
    over the eff_inf-scaled host estimate, and ``codec_bws_measured``
    records which path was used (surfaced in BENCH_fleet.json)."""
    reg = DeviceRegistry(heartbeat_timeout_s=1e9)
    reg.codec_bws = {"int8": 1e9}          # host-measured calibration

    est = reg.add(_sim_worker("est", factor=0.5))
    assert est.codec_bws_measured is False
    assert est.codec_bws["int8"] == pytest.approx(0.5e9)  # scaled estimate

    meas = _sim_worker("meas", factor=0.5)
    meas.measure_codec_bws = lambda: {"int8": 123.0}   # the RPC boundary
    reg.add(meas)
    assert meas.codec_bws_measured is True
    assert meas.codec_bws == {"int8": 123.0}           # measured, unscaled


def test_calibration_falls_back_to_estimate_on_measure_failure():
    """A wire hiccup during Calibrate must not leave the worker
    uncalibrated: the registry falls back to the scaled estimate and the
    provenance flag says so."""
    reg = DeviceRegistry(heartbeat_timeout_s=1e9)
    reg.codec_bws = {"int8": 1e9}

    def boom():
        raise RuntimeError("wire hiccup")

    w = _sim_worker("flaky", factor=0.5)
    w.measure_codec_bws = boom
    reg.add(w)
    assert w.codec_bws_measured is False
    assert w.codec_bws["int8"] == pytest.approx(0.5e9)


def test_readmit_remeasures_through_the_worker():
    """Re-admission re-runs calibration through the worker's own
    measurement when it supports one (a revived process may perform
    differently than it did before it died)."""
    reg = DeviceRegistry(heartbeat_timeout_s=1e9)
    w = _sim_worker("m", factor=1.0)
    calls = []
    w.measure_codec_bws = lambda: calls.append(1) or {"int8": 7.0}
    reg.add(w)
    assert calls == [1] and w.codec_bws == {"int8": 7.0}
    reg.fail("m")
    assert reg.check_dead() == ["m"]
    reg.readmit("m")
    assert calls == [1, 1]                 # measured again on revive
    assert w.codec_bws_measured is True


# --- against the JAX package ------------------------------------------------

def _placements(pkg, seed):
    """A three-board SimWorker fleet (eff 1.0 / 0.6 / 0.35) driven in
    virtual time by one seeded Poisson trace, with ``edge-b`` failed a
    third of the way in → placements, completions and router stats."""
    import importlib
    fleet = importlib.import_module(f"{pkg}.fleet")
    prof = importlib.import_module(f"{pkg}.profiling")
    hw_mod = importlib.import_module(f"{pkg}.profiling.hardware")
    Req = importlib.import_module(f"{pkg}.serving.queue").Request
    reg = fleet.DeviceRegistry(heartbeat_timeout_s=1e9)
    for i, f in enumerate((1.0, 0.6, 0.35)):
        hw = fleet.scaled_hardware(hw_mod.JETSON_ORIN_NANO, f)
        pm = prof.get_backend("simulated").profile(
            prof.ProfileContext(hardware=hw), prof.SweepSpec())
        reg.add(fleet.SimWorker(f"edge-{'abc'[i]}", perfmap=pm, hardware=hw,
                                queue_size=8))
    rng = np.random.RandomState(seed)
    arrivals = np.cumsum(rng.exponential(1 / 40.0, 24))
    reqs = [Req(prompt=rng.randint(0, 64, 8), n_new=16, seed=i,
                arrival_ts=float(arrivals[i])) for i in range(24)]
    base = reqs[0].id
    router = fleet.FleetRouter(reg, clock=lambda: 0.0)
    out = router.drive_virtual(
        reqs, events=[(float(arrivals[8]), lambda: reg.fail("edge-b"))])
    placed = [(r.request_id - base, r.worker, r.reason,
               [s.explain() for s in r.scores]) for r in router.placements]
    done = sorted((c.request_id - base, c.worker, c.plan_key,
                   round(c.finished_ts, 9)) for c in out["completions"])
    snap = router.stats_snapshot()
    return placed, done, (snap["routed"], snap["rerouted"], snap["dead"])


def test_sim_fleet_placements_equal_the_jax_packages():
    """The same seeded virtual-time fleet places every request on the same
    worker with the same scored ranking, and finishes it at the same
    virtual time, in both packages — failover included."""
    mine, theirs = _placements("repro_torch", 7), _placements("repro", 7)
    assert mine == theirs
    assert mine[2][1] > 0 and mine[2][2] == ["edge-b"]


def test_real_fleet_failover_equals_the_jax_fleet():
    """Two real workers per package on the same f32 weights (the JAX
    params bridged into the port), one killed after the first step: the
    port's fleet serves every request with the JAX fleet's tokens."""
    import jax
    from repro.api import ExecutionPlan as JPlan
    from repro.api import InferenceSession as JSession
    from repro.fleet import DeviceRegistry as JRegistry
    from repro.fleet import FleetRouter as JRouter
    from repro.fleet import WorkerHandle as JHandle
    from repro_torch.configs import get_config
    from repro_torch.models.bridge import params_from_numpy
    reduced = {"vocab_size": 64, "dtype": "float32"}
    prompts = [_prompt(5, seed=i) for i in range(6)]
    tokens = {}
    for side in ("jax", "torch"):
        sessions = []
        for _ in range(2):
            js = JSession.from_config(
                "llama3.2-1b", reduced=reduced, seed=0,
                plans=[JPlan.local(), JPlan.prism_sim(L=4, cr=9.9)])
            if side == "torch":
                cfg = get_config("llama3.2-1b").reduced(**reduced)
                js = InferenceSession(
                    cfg, params_from_numpy(
                        jax.tree.map(np.asarray, js.params), cfg),
                    [ExecutionPlan.local(),
                     ExecutionPlan.prism_sim(L=4, cr=9.9)], device="cpu")
            js.profile(backend="simulated")
            sessions.append(js)
        reg_cls, router_cls, handle = ((JRegistry, JRouter, JHandle)
                                       if side == "jax" else
                                       (DeviceRegistry, FleetRouter,
                                        WorkerHandle))
        reg = reg_cls(heartbeat_timeout_s=1e9)
        for i, s in enumerate(sessions):
            reg.add(handle(f"w{i + 1}", s, n_slots=2, chunk=3, max_len=24))
        router = router_cls(reg)
        placed = router.fanout(prompts, 6)
        router.step()
        reg.fail("w1")
        router.run()
        tokens[side] = [np.asarray(router.completion_for(r.id).tokens)
                        for r, _ in placed]
        assert router.stats_snapshot()["dead"] == ["w1"]
    for a, b in zip(tokens["torch"], tokens["jax"]):
        np.testing.assert_array_equal(a, b)
