"""The port's chaos tier on the CPU (``repro_torch.chaos``), mirroring the
JAX package's ``tests/test_chaos.py``: seeded fault schedules, the
controller choke point, and the retry/timeout/breaker/readmission
machinery they exercise, the serving runtime's chaos hook included.

Injection is deterministic by construction (all randomness at schedule
build time), so every test here asserts exact state transitions.  Against
the JAX package: ``FaultSchedule.parse`` of the same spec, and
``RetryPolicy``/``CircuitBreaker`` under one script, agree exactly."""
import numpy as np
import pytest

from repro_torch.api import ExecutionPlan, InferenceSession
from repro_torch.chaos import (ChaosController, ChaosEvent, DispatchFault,
                         FaultSchedule)
from repro_torch.fleet import (DeviceRegistry, FleetRejected, FleetRouter,
                         ReadmissionEvent, SimWorker, WorkerHandle,
                         scaled_hardware)
from repro_torch.profiling import ProfileContext, SweepSpec, get_backend
from repro_torch.profiling.hardware import JETSON_ORIN_NANO
from repro_torch.runtime.fault import (CircuitBreaker, HeartbeatMonitor,
                                 RetryPolicy)
from repro_torch.serving.queue import Request, RequestQueue
from repro_torch.transport.codecs import codec_overrides, get_codec, list_codecs
from repro_torch.utils.bandwidth import BandwidthWalk


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


def _fleet(names, **kw):
    reg = DeviceRegistry(heartbeat_timeout_s=1e9)
    for n in names:
        reg.add(_sim_worker(n, **kw))
    return reg


def _req(n_new=2, arrival_ts=0.0, **kw):
    return Request(prompt=_prompt(8), n_new=n_new, arrival_ts=arrival_ts,
                   **kw)


# --- schedules ---------------------------------------------------------------

def test_schedule_sorts_and_composes():
    sched = FaultSchedule().add(FaultSchedule.revive("a", 3.0),
                                FaultSchedule.kill("a", 1.0))
    assert [e.kind for e in sched] == ["kill", "revive"]
    merged = sched + FaultSchedule([FaultSchedule.stall("b", 2.0, 0.5)])
    assert [(e.t, e.kind) for e in merged] == [
        (1.0, "kill"), (2.0, "stall"), (3.0, "revive")]
    assert len(merged) == 3


def test_chaos_event_validation():
    with pytest.raises(ValueError, match="unknown chaos event kind"):
        ChaosEvent(0.0, "explode", "a")
    with pytest.raises(ValueError, match="must be >= 0"):
        ChaosEvent(-1.0, "kill", "a")


def test_schedule_parse_all_kinds():
    sched = FaultSchedule.parse(
        "kill:b@1; revive:b@3; bw:a@0.5:250; flap:c@2:0.5:5;"
        " stall:a@2:0.25; straggle:c@1:3; error:c@1.5:0.1;"
        " drift:a@4:600->60:2")
    assert len(sched) == 7 + 16          # drift expands to 16 bw events
    times = [e.t for e in sched]
    assert times == sorted(times)
    by_kind = {}
    for e in sched:
        by_kind.setdefault(e.kind, []).append(e)
    assert by_kind["kill"][0].target == "b"
    assert by_kind["flap"][0].value == 5.0
    assert by_kind["flap"][0].duration == 0.5
    assert by_kind["straggle"][0].value == 3.0
    assert by_kind["error"][0].value == 0.1
    assert len(by_kind["bandwidth"]) == 17    # 1 explicit + 16 drift
    with pytest.raises(ValueError, match="bad chaos clause"):
        FaultSchedule.parse("bogus")
    with pytest.raises(ValueError, match="unknown chaos kind"):
        FaultSchedule.parse("wibble:a@1")


def test_drift_is_seed_deterministic():
    a = FaultSchedule.drift("a", 0.0, 8.0, 600.0, 60.0, seed=3)
    b = FaultSchedule.drift("a", 0.0, 8.0, 600.0, 60.0, seed=3)
    c = FaultSchedule.drift("a", 0.0, 8.0, 600.0, 60.0, seed=4)
    assert [(e.t, e.value) for e in a] == [(e.t, e.value) for e in b]
    assert [e.value for e in a] != [e.value for e in c]
    assert all(e.kind == "bandwidth" for e in a)
    with pytest.raises(ValueError, match="t1 > t0"):
        FaultSchedule.drift("a", 2.0, 2.0, 600.0, 60.0)


def test_bandwidth_walk():
    w = BandwidthWalk(600.0, 60.0, seed=5, jitter=0.1)
    assert w.at(0.0) == pytest.approx(600.0, rel=0.1)
    assert w.at(1.0) == pytest.approx(60.0, rel=0.1)
    assert w.at(-3.0) == w.at(0.0) and w.at(9.0) == w.at(1.0)
    assert w.sample(8) == BandwidthWalk(600.0, 60.0, seed=5,
                                        jitter=0.1).sample(8)
    with pytest.raises(ValueError, match="jitter"):
        BandwidthWalk(600.0, 60.0, jitter=1.0)
    with pytest.raises(ValueError, match="endpoints"):
        BandwidthWalk(0.0, 60.0)


# --- retry policy + circuit breaker ------------------------------------------

def test_retry_policy_backoff_and_cap():
    p = RetryPolicy(max_retries=3, backoff_base_s=0.05, backoff_mult=2.0)
    assert [p.backoff_s(k) for k in range(3)] == [0.05, 0.1, 0.2]
    assert p.backoff_s(-4) == 0.05           # clamped to attempt 0
    # uncapped doubling would be 0.05 * 2^100 seconds — the cap holds
    assert p.backoff_s(100) == p.backoff_cap_s == 30.0
    with pytest.raises(ValueError):
        RetryPolicy(max_retries=-1)
    with pytest.raises(ValueError):
        RetryPolicy(backoff_mult=0.5)
    with pytest.raises(ValueError):
        RetryPolicy(backoff_cap_s=0.0)


def test_circuit_breaker_state_machine():
    br = CircuitBreaker(fail_threshold=2, reset_timeout_s=1.0)
    assert br.state == "closed" and br.allows(0.0)
    assert not br.record_failure(0.0)           # 1/2 — still closed
    assert br.record_failure(0.1)               # 2/2 — newly opened
    assert br.state == "open" and br.opened_total == 1
    assert not br.allows(0.5)                   # inside the reset window
    br.record_success(0.5)                      # draining old work: ignored
    assert br.state == "open"
    assert br.allows(1.2)                       # window elapsed → probe
    assert br.state == "half_open"
    assert br.record_failure(1.3)               # failed probe re-opens
    assert br.state == "open" and br.opened_total == 2
    assert br.allows(2.5) and br.state == "half_open"
    br.record_success(2.5)                      # probe succeeded
    assert br.state == "closed" and br.failures == 0
    br.record_failure(3.0)
    br.record_success(3.1)                      # closed success resets count
    assert br.failures == 0
    br.record_failure(4.0)
    br.reset()
    assert br.state == "closed" and br.failures == 0
    assert br.snapshot() == {"state": "closed", "failures": 0,
                             "opened_total": 2}
    with pytest.raises(ValueError):
        CircuitBreaker(fail_threshold=0)


# --- controller --------------------------------------------------------------

def test_controller_attaches_and_replays_kill_revive():
    reg = _fleet(["a", "b"])
    sched = FaultSchedule().add(FaultSchedule.kill("a", 1.0),
                                FaultSchedule.revive("a", 2.0))
    chaos = ChaosController(reg, sched)
    assert reg.get("a").chaos is chaos          # attach wired the worker
    before = reg.get("a").profiled_count
    for _, fn in chaos.events():
        fn()
    assert reg.is_alive("a")
    # registry-level revive goes through full readmission → re-profile
    assert reg.get("a").profiled_count == before + 1
    assert chaos.log == [[1.0, "kill", "a", 0.0], [2.0, "revive", "a", 0.0]]


def test_controller_flap_restores_preflap_bandwidth():
    reg = _fleet(["a"])
    w = reg.get("a")
    w.observe_bandwidth(500.0)
    chaos = ChaosController(
        reg, FaultSchedule([FaultSchedule.flap("a", 1.0, 0.5,
                                               floor_mbps=2.0)]))
    evs = chaos.events()
    assert [t for t, _ in evs] == [1.0, 1.5]    # down + restore
    evs[0][1]()
    assert w.bandwidth == 2.0
    evs[1][1]()
    assert w.bandwidth == 500.0
    assert [row[1] for row in chaos.log] == ["flap_down", "flap_up"]


def test_dispatch_fault_armed_fires_exactly_once():
    reg = _fleet(["a"])
    chaos = ChaosController(reg, FaultSchedule())
    chaos.apply(FaultSchedule.straggle("a", 1.0, 4.0))
    assert chaos.pending_faults == 1
    assert chaos.dispatch_fault("a", 0.5) is None     # not due yet
    assert chaos.dispatch_fault("b", 2.0) is None     # wrong worker
    ev = chaos.dispatch_fault("a", 1.2)
    assert ev is not None and ev.kind == "straggle" and ev.value == 4.0
    assert chaos.dispatch_fault("a", 2.0) is None     # consumed
    assert chaos.pending_faults == 0
    assert [row[1] for row in chaos.log] == ["arm_straggle",
                                             "hit_straggle"]


# --- SimWorker fault paths ---------------------------------------------------

def test_simworker_transport_error_requeues_with_backoff():
    retry = RetryPolicy(max_retries=2, backoff_base_s=0.5)
    reg = DeviceRegistry(heartbeat_timeout_s=1e9)
    w = reg.add(_sim_worker("a", retry=retry))
    chaos = ChaosController(reg, FaultSchedule())
    chaos.apply(FaultSchedule.transport_error("a", 0.0, abort_s=0.01))
    req = _req()
    w.submit_request(req)
    w.step(0.0)                        # admit → armed error dooms dispatch
    assert w.in_flight == 1
    assert w.step(0.02) == []          # aborts, no completion
    faults = w.pop_faults()
    assert len(faults) == 1
    assert faults[0].kind == "error" and faults[0].retried == (req.id,)
    assert faults[0].gave_up == ()
    assert w.pop_faults() == []        # consume pattern
    assert len(w.queue) == 1           # requeued locally
    # exponential backoff: no admission until the backoff window passes
    assert w.next_event_at(0.02) == pytest.approx(0.01 + 0.5)
    w.step(0.1)
    assert w.in_flight == 0
    w.step(0.6)                        # backoff elapsed, fault consumed
    assert w.in_flight == 1
    snap = w.stats_snapshot()
    assert snap["transport_errors"] == 1 and snap["retries"] == 1


def test_simworker_gives_up_past_retry_budget():
    reg = DeviceRegistry(heartbeat_timeout_s=1e9)
    w = reg.add(_sim_worker("a", retry=RetryPolicy(max_retries=0)))
    chaos = ChaosController(reg, FaultSchedule())
    chaos.apply(FaultSchedule.transport_error("a", 0.0, abort_s=0.01))
    req = _req()
    w.submit_request(req)
    w.step(0.0)
    w.step(0.02)
    faults = w.pop_faults()
    assert faults[0].gave_up == (req,) and faults[0].retried == ()
    assert len(w.queue) == 0           # handed back, not requeued
    assert w.stats_snapshot()["gave_up"] == 1


def test_simworker_dispatch_timeout():
    w = _sim_worker("a", dispatch_timeout_s=1e-4)
    w.submit_request(_req())
    w.step(0.0)                        # any real service exceeds 0.1 ms
    assert w._busy_until == pytest.approx(1e-4)
    assert w.step(1.0) == []
    faults = w.pop_faults()
    assert faults[0].kind == "timeout"
    assert w.stats_snapshot()["timeouts"] == 1


def test_simworker_straggle_inflates_service():
    reg = DeviceRegistry(heartbeat_timeout_s=1e9)
    w = reg.add(_sim_worker("a"))
    w.submit_request(_req())
    w.step(0.0)
    base = w._busy_until
    w.drain_requests()
    chaos = ChaosController(reg, FaultSchedule())
    chaos.apply(FaultSchedule.straggle("a", 0.0, 3.0))
    w.submit_request(_req(arrival_ts=10.0))
    w.step(10.0)
    assert w._busy_until - 10.0 == pytest.approx(3.0 * base)
    assert w.stats_snapshot()["straggled"] == 1


def test_simworker_stall_defers_admission_and_extends_service():
    w = _sim_worker("a")
    w.submit_request(_req())
    w.apply_stall(0.0, 1.0)
    w.step(0.5)
    assert w.in_flight == 0            # stalled: nothing admitted
    assert w.next_event_at(0.5) == 1.0
    w.step(1.0)
    assert w.in_flight == 1
    busy = w._busy_until
    w.apply_stall(1.1, 0.5)            # mid-service stall finishes late
    assert w._busy_until == pytest.approx(busy + 0.5)


def test_static_worker_plans_frozen_but_pays_true_bandwidth():
    w = _sim_worker("a", adaptive=False, bandwidth_mbps=600.0)
    w.observe_bandwidth(30.0)          # link degraded after planning froze
    table = w.table()
    bp = table.plan_batch(1, 600.0, max_batch=4)   # the frozen plan
    d = bp.decision
    true_ms = next(exp.total_ms
                   for key, exp in table.candidates(bp.batch, 30.0)
                   if (key.mode, key.cr, key.codec)
                   == (d.mode, d.cr, d.codec))
    req = _req(n_new=4)
    w.submit_request(req)
    w.step(0.0)
    assert w._service_key == d.exec_key            # planned at 600 Mbps
    assert w._busy_until == pytest.approx(1e-3 * true_ms * 4)
    # an adaptive twin re-plans at the live link instead
    wa = _sim_worker("b", adaptive=True, bandwidth_mbps=600.0)
    wa.observe_bandwidth(30.0)
    bpa = wa.table().plan_batch(1, 30.0, max_batch=4)
    wa.submit_request(_req(n_new=4))
    wa.step(0.0)
    assert wa._busy_until == pytest.approx(
        1e-3 * bpa.decision.expected.total_ms * 4)


# --- router: breakers, placement retries, re-placement, readmission ----------

def test_router_skips_breaker_open_workers():
    reg = _fleet(["a", "b"])
    router = FleetRouter(reg, clock=lambda: 0.0, breaker_threshold=1,
                         breaker_reset_s=5.0)
    router.breaker("a").record_failure(0.0)        # threshold 1 → open
    assert [s.worker for s in router.rank(now=0.0)] == ["b"]
    req, rec = router.submit(_prompt(8), 2)
    assert rec.worker == "b"
    # pinned to a breaker-open worker: shed with the machine reason
    with pytest.raises(FleetRejected) as ei:
        router.route(_req(), pin="a", now=0.0)
    assert ei.value.reason == "breaker_open"
    assert reg.get("a").queue.rejections["breaker_open"] == 1
    # every live worker blocked → breaker_open, not no_workers
    router.breaker("b").record_failure(0.0)
    with pytest.raises(FleetRejected) as ei:
        router.route(_req(), now=0.0)
    assert ei.value.reason == "breaker_open"
    # past the reset window both half-open and placement resumes
    assert {s.worker for s in router.rank(now=10.0)} == {"a", "b"}


def test_drive_virtual_retries_rejected_placements():
    reg = DeviceRegistry(heartbeat_timeout_s=1e9)
    reg.add(_sim_worker("a", n_slots=1, queue_size=1))
    router = FleetRouter(
        reg, retry=RetryPolicy(max_retries=10, backoff_base_s=0.2),
        clock=lambda: 0.0)
    reqs = [_req(n_new=1, arrival_ts=0.0) for _ in range(4)]
    out = router.drive_virtual(reqs)
    assert len(out["completions"]) == 4 and out["shed"] == []
    assert router.stats["placement_retries"] >= 3


def test_drive_virtual_without_retry_sheds_immediately():
    reg = DeviceRegistry(heartbeat_timeout_s=1e9)
    reg.add(_sim_worker("a", n_slots=1, queue_size=1))
    router = FleetRouter(reg, clock=lambda: 0.0)    # retry=None: one shot
    reqs = [_req(n_new=1, arrival_ts=0.0) for _ in range(4)]
    out = router.drive_virtual(reqs)
    assert len(out["shed"]) > 0
    assert router.stats["placement_retries"] == 0


def test_router_replaces_gave_up_requests_on_survivor():
    reg = _fleet(["a", "b"])
    reg.get("a").retry = RetryPolicy(max_retries=0)
    router = FleetRouter(reg, clock=lambda: 0.0, breaker_threshold=1)
    chaos = ChaosController(reg, FaultSchedule(), router=router)
    chaos.apply(FaultSchedule.transport_error("a", 0.0, abort_s=0.01))
    out = router.drive_virtual([_req(n_new=1, arrival_ts=0.0)])
    assert len(out["completions"]) == 1
    assert out["completions"][0].worker == "b"      # re-placed after a's abort
    snap = router.stats_snapshot()
    assert snap["gave_up"] == 1 and snap["transport_errors"] == 1
    assert snap["breaker_opened"] == 1
    assert snap["breakers"]["a"]["opened_total"] == 1


def test_router_counts_lost_when_no_survivor():
    reg = _fleet(["a"])
    reg.get("a").retry = RetryPolicy(max_retries=0)
    router = FleetRouter(reg, clock=lambda: 0.0)
    chaos = ChaosController(reg, FaultSchedule(), router=router)
    chaos.apply(FaultSchedule.transport_error("a", 0.0, abort_s=0.01))
    out = router.drive_virtual([_req(n_new=1, arrival_ts=0.0)])
    assert out["completions"] == []
    assert router.stats["lost"] == 1 and router.stats["gave_up"] == 1


def test_readmit_resets_breaker_and_reprofiles():
    reg = _fleet(["a"])
    w = reg.get("a")
    router = FleetRouter(reg, clock=lambda: 0.0, breaker_threshold=1)
    reg.fail("a")
    assert reg.check_dead() == ["a"]
    router.breaker("a").record_failure(0.0)
    before = w.profiled_count
    got = router.readmit("a", now=1.5)
    assert got is w and reg.is_alive("a")
    assert w.profiled_count == before + 1
    assert router.breaker("a").state == "closed"
    evs = [e for e in router.events if isinstance(e, ReadmissionEvent)]
    assert len(evs) == 1 and evs[0].worker == "a" and evs[0].at == 1.5
    snap = router.stats_snapshot()
    assert snap["readmitted"] == 1 and snap["readmissions"] == 1


def test_router_telemetry_keys():
    router = FleetRouter(_fleet(["a"]), clock=lambda: 0.0)
    snap = router.stats_snapshot()
    for key in ("retries", "timeouts", "transport_errors", "gave_up",
                "placement_retries", "breaker_opened", "readmitted",
                "failovers", "readmissions", "breakers"):
        assert key in snap, key


# --- satellite: liveness invariants ------------------------------------------

def test_heartbeat_revive_restarts_deadline():
    t = [0.0]
    mon = HeartbeatMonitor(["a"], timeout_s=5.0, clock=lambda: t[0])
    mon.fail("a")
    mon.beat("a")                          # beats ignored while failed
    assert mon.dead_nodes() == ["a"]
    t[0] = 100.0
    mon.revive("a")                        # clears failure AND re-arms
    assert mon.dead_nodes() == []
    t[0] = 104.0
    assert mon.dead_nodes() == []          # deadline restarted at revive
    t[0] = 106.0
    assert mon.dead_nodes() == ["a"]       # then expires normally


def test_check_dead_consumes_each_death_exactly_once_seeded():
    """Property-style: under seeded interleaved beat/fail/revive traffic, a
    worker is reported by ``check_dead`` at most once per revival."""
    rng = np.random.RandomState(1234)
    t = [0.0]
    reg = DeviceRegistry(heartbeat_timeout_s=5.0, clock=lambda: t[0])
    names = ["a", "b", "c"]
    for n in names:
        reg.add(_sim_worker(n))
    reported_since_revive = set()
    reports = {n: 0 for n in names}
    revives = {n: 0 for n in names}
    for _ in range(300):
        t[0] += rng.uniform(0.0, 2.0)
        for n in names:
            if rng.rand() < 0.8:
                reg.beat(n)
        if rng.rand() < 0.15:
            reg.fail(rng.choice(names))
        if rng.rand() < 0.3:
            dead = reg.dead()
            if dead:
                n = rng.choice(dead)
                reg.revive(n)
                revives[n] += 1
                reported_since_revive.discard(n)
        for n in reg.check_dead():
            assert n not in reported_since_revive, \
                f"{n} reported dead twice without an intervening revive"
            reported_since_revive.add(n)
            reports[n] += 1
    for n in names:
        assert reports[n] <= revives[n] + 1


# --- satellite: shed-on-expired ----------------------------------------------

def test_queue_shed_expired_is_opt_in():
    q = RequestQueue(8)                     # default: late work dispatches
    r = _req(slo_ms=10.0)
    q.put(r)
    assert q.pop(now=5.0) is r
    assert q.rejections == {}

    q2 = RequestQueue(8, shed_expired=True)
    late = _req(slo_ms=10.0)
    ok = _req(slo_ms=10_000.0)
    q2.put(late)
    q2.put(ok)
    assert q2.pop(now=5.0) is ok            # deadline-passed work dropped
    assert q2.expired == [late]
    assert q2.rejections["expired"] == 1
    q2.put(_req(slo_ms=1.0))
    assert q2.pop_many(4, now=5.0) == []    # only expired left → nothing
    assert q2.rejections["expired"] == 2


def test_simworker_shed_expired_surfaces_in_stats():
    w = _sim_worker("a", shed_expired=True)
    w.submit_request(_req(slo_ms=10.0, arrival_ts=0.0))
    w.step(5.0)                             # expired before admission
    assert w.in_flight == 0
    assert w.stats_snapshot()["expired"] == 1


# --- satellite: per-device codec calibration ---------------------------------

def _measurable_codec():
    return next(n for n in list_codecs()
                if type(get_codec(n)).decode_bw > 0
                and not get_codec(n).summarizing)


def test_codec_overrides_install_and_restore_exactly():
    name = _measurable_codec()
    codec = get_codec(name)
    before = (codec.__dict__.get("decode_bw"),
              codec.__dict__.get("decode_bw_measured"))
    with codec_overrides({name: 123.0}):
        assert get_codec(name).decode_bw == 123.0
        assert get_codec(name).decode_bw_measured
    after = (codec.__dict__.get("decode_bw"),
             codec.__dict__.get("decode_bw_measured"))
    assert after == before


def test_device_codec_bws_scale_with_hardware():
    name = _measurable_codec()
    reg = DeviceRegistry(heartbeat_timeout_s=1e9)
    reg.codec_bws = {name: 1e9}            # pretend the host measured 1 GB/s
    w = _sim_worker("slow", factor=0.5)
    assert reg.device_codec_bws(w)[name] == pytest.approx(0.5e9)
    before = w.profiled_count
    reg.add(w)                             # add() calibrates + re-profiles
    assert w.codec_bws[name] == pytest.approx(0.5e9)
    assert w.profiled_count == before + 1


def test_readmit_recalibrates_codecs_for_the_device():
    name = _measurable_codec()
    reg = DeviceRegistry(heartbeat_timeout_s=1e9)
    w = reg.add(_sim_worker("slow", factor=0.5))
    reg.codec_bws = {name: 2e9}            # host calibration after add()
    reg.fail("slow")
    assert reg.check_dead() == ["slow"]
    before = w.profiled_count
    reg.readmit("slow")
    assert reg.is_alive("slow")
    assert w.codec_bws[name] == pytest.approx(1e9)   # re-scaled on revive
    assert w.profiled_count == before + 1
    # opting out leaves the profile untouched (plain revive)
    reg.fail("slow")
    reg.check_dead()
    reg.readmit("slow", recalibrate=False, reprofile=False)
    assert w.profiled_count == before + 1


# --- real-worker chaos hook --------------------------------------------------

def test_serving_runtime_consumes_dispatch_faults():
    s = InferenceSession.from_config(
        "llama3.2-1b", reduced={"vocab_size": 64}, device="cpu",
        plans=[ExecutionPlan.local()])
    s.profile(backend="simulated")
    reg = DeviceRegistry(heartbeat_timeout_s=1e9)
    w = reg.add(WorkerHandle("w", s, n_slots=2, max_len=64))
    chaos = ChaosController(reg, FaultSchedule())
    assert w.runtime.chaos is chaos        # attach wired through the runtime
    chaos.apply(FaultSchedule.straggle("w", 0.0, 3.0))
    chaos.apply(FaultSchedule.transport_error("w", 0.0))
    router = FleetRouter(reg)
    # >1 decode chunk (chunk=8), so the error fault hits a later dispatch
    placed = router.fanout([_prompt(6)], 20)
    assert placed[0][1] is not None
    router.run()
    comp = router.completion_for(placed[0][0].id)
    assert comp is not None and len(comp.tokens) == 20  # aborts don't lose
    snap = w.runtime.stats_snapshot()
    assert snap["straggled"] == 1 and snap["retries"] == 1
    for key in ("expired", "failovers"):
        assert key in snap, key
    assert chaos.pending_faults == 0


def test_chaos_kill_reaches_a_real_process_boundary():
    """A ``kill`` event on a process-backed worker must SIGKILL the
    subprocess (not just flip registry membership): the controller calls
    ``kill_process`` when the worker exposes one and marks the worker
    unhealthy so ``readmit`` knows to respawn it."""
    reg = DeviceRegistry(heartbeat_timeout_s=1e9)
    w = reg.add(_sim_worker("proc", factor=1.0))
    killed = []
    w.kill_process = lambda: killed.append(True)
    chaos = ChaosController(reg, FaultSchedule())
    chaos.apply(ChaosEvent(0.5, "kill", "proc"))
    assert killed == [True]                 # the process died for real
    assert w.healthy is False               # recorded for readmission
    assert not reg.is_alive("proc")
    assert ["kill", "proc"] in [[r[1], r[2]] for r in chaos.log]


def test_chaos_kill_on_sim_worker_is_membership_only():
    """SimWorkers have no subprocess — kill stays a membership change and
    leaves ``healthy`` alone (the model does not pretend a process died)."""
    reg = DeviceRegistry(heartbeat_timeout_s=1e9)
    w = reg.add(_sim_worker("sim", factor=1.0))
    chaos = ChaosController(reg, FaultSchedule())
    chaos.apply(ChaosEvent(0.5, "kill", "sim"))
    assert w.healthy is True
    assert not reg.is_alive("sim")


# --- against the JAX package ------------------------------------------------

PARSE_SPECS = [
    "kill:b@1; revive:b@3; bw:a@0.5:250; flap:c@2:0.5:5;"
    " stall:a@2:0.25; straggle:c@1:3; error:c@1.5:0.1;"
    " drift:a@4:600->60:2",
    "kill:edge-b@0.5;revive:edge-b@2;drift:edge-a@0:600->60:4;"
    "error:edge-c@1.5",
]


@pytest.mark.parametrize("spec", PARSE_SPECS)
def test_schedule_parse_equals_the_jax_packages(spec):
    """``FaultSchedule.parse`` of one spec gives the same events, the
    seeded drift walk included, in both packages."""
    import dataclasses
    from repro.chaos import FaultSchedule as JSchedule
    mine = [dataclasses.astuple(e) for e in FaultSchedule.parse(spec)]
    theirs = [dataclasses.astuple(e) for e in JSchedule.parse(spec)]
    assert mine == theirs and mine


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_retry_policy_and_breaker_agree_across_packages(pkg):
    """``RetryPolicy``'s capped backoff and ``CircuitBreaker``'s state
    machine, driven by one script in each package, give one trace."""
    import importlib
    fault = importlib.import_module(f"{pkg}.runtime.fault")
    from repro.runtime.fault import CircuitBreaker as JBreaker
    from repro.runtime.fault import RetryPolicy as JRetry

    def script(retry_cls, breaker_cls):
        p = retry_cls(max_retries=4, backoff_base_s=0.1, backoff_mult=3.0,
                      backoff_cap_s=2.0)
        b = breaker_cls(fail_threshold=2, reset_timeout_s=1.0)
        out = [p.backoff_s(k) for k in range(6)]
        for t, ok in [(0.0, False), (0.1, False), (0.5, True), (1.2, None),
                      (1.3, False), (2.5, None), (2.6, True), (2.7, False)]:
            if ok is None:
                out.append(b.allows(t))
            elif ok:
                b.record_success(t)
            else:
                out.append(b.record_failure(t))
            out.append(tuple(sorted(b.snapshot().items())))
        return out

    assert (script(fault.RetryPolicy, fault.CircuitBreaker)
            == script(JRetry, JBreaker))
