"""The port's serving runtime on reduced f32 llama3.2-1b, on the CPU.

* ``ServingRuntime`` dense (with and without the int8 cache) and paged,
  under ``local`` and ``prism_sim``: greedy tokens of every request equal
  the JAX package's ``ServingRuntime`` on the same request stream and the
  same weights (bridged), and the page/prefix counters are equal;
* sampled serving: a request's tokens depend on its seed only — not on the
  admission order or what shares the pool — and equal the port's B=1
  ``generate``;
* the host bookkeeping (allocator, queue, scheduler, hooks), where it is
  host logic only, as one test over both packages;
* the paged pool's admission rollback, eviction, page-bounded admission
  and cold pages; the launcher as a subprocess.
"""
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _hypothesis_fallback import given, settings, st
from repro.api import ExecutionPlan as JPlan
from repro.api import InferenceSession as JSession
from repro.serving import ServingRuntime as JRuntime
from repro_torch.api import ExecutionPlan as TPlan
from repro_torch.api import InferenceSession as TSession
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving import (PagedPool, QueueFull, Request,
                                 ServingRuntime)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "llama3.2-1b"
VOCAB = 64


def _pair(mode="local", kv_quant=False):
    """(JAX session, port session) over the same f32 weights, the plan
    pinned to ``mode`` as a deployment pins it."""
    reduced = {"dtype": "float32", "vocab_size": VOCAB, "kv_quant": kv_quant}
    allow = (mode,)
    js = JSession.from_config(ARCH, plans=[JPlan.local(),
                                           JPlan.prism_sim(L=2, cr=9.9)],
                              reduced=reduced, seed=0, allow_modes=allow)
    tparams = params_from_numpy(jax.tree.map(np.asarray, js.params), js.cfg)
    ts = TSession.from_config(ARCH, plans=[TPlan.local(),
                                           TPlan.prism_sim(L=2, cr=9.9)],
                              reduced=reduced, params=tparams, device="cpu",
                              allow_modes=allow)
    js.profile(backend="simulated")
    ts.profile(backend="simulated")
    return js, ts


_PAIRS = {}


def pair(mode="local", kv_quant=False):
    if (mode, kv_quant) not in _PAIRS:
        _PAIRS[(mode, kv_quant)] = _pair(mode, kv_quant)
    return _PAIRS[(mode, kv_quant)]


@pytest.fixture(scope="module")
def session():
    return pair()[1]


def _prompt(T0, seed=0):
    return np.random.RandomState(seed).randint(1, VOCAB, T0)


def _served(rt, reqs):
    done = {c.request_id: c.tokens for c in rt.run()}
    return [done[r.id] for r in reqs]


def _ref(session, req):
    return session.generate(torch.as_tensor(req.prompt)[None], req.n_new,
                            seed=req.seed,
                            temperature=req.temperature)[0].numpy()


# --- the runtime against the JAX package's ----------------------------------

BASE = list(_prompt(13, seed=42))           # unaligned at page size 8
STREAM = [BASE, BASE, BASE + [7, 3, 9], BASE + [5], list(_prompt(6, 1)),
          list(_prompt(9, 2))]
COUNTERS = ("prefix_hits", "prefix_misses", "full_hits", "partial_hits",
            "cow_splits", "pages_free", "pages_committed", "prefix_entries")


def _stream(rt):
    return [rt.submit(np.asarray(p), 5, seed=i) for i, p in enumerate(STREAM)]


@pytest.mark.parametrize("pool", ["dense", "dense_int8", "paged"])
@pytest.mark.parametrize("mode", ["local", "prism"])
def test_runtime_greedy_tokens_equal_jax_runtime(mode, pool):
    """One request stream (a prompt, the same prompt again, two prompts
    extending it, two others) through the JAX package's runtime and the
    port's: every request's greedy tokens equal; paged, the page and
    prefix counters are equal too (a full hit, two partial hits,
    copy-on-write tail splits)."""
    js, ts = pair(mode, kv_quant=pool == "dense_int8")
    kw = (dict(page_size=8, n_pages=24, n_rows=3) if pool == "paged"
          else dict(n_slots=2))
    runs = []
    for runtime, s in ((JRuntime, js), (ServingRuntime, ts)):
        rt = runtime(s, chunk=3, max_len=32, **kw)
        runs.append((_served(rt, _stream(rt)), rt.stats_snapshot()))
    (want, jstats), (got, tstats) = runs
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert tstats["completed"] == len(STREAM) == jstats["completed"]
    if pool == "paged":
        assert ({k: tstats[k] for k in COUNTERS}
                == {k: jstats[k] for k in COUNTERS})
        assert (tstats["full_hits"], tstats["partial_hits"]) == (1, 2)
        assert tstats["cow_splits"] >= 3


# --- sampled serving ---------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_sampled_tokens_follow_the_seed_not_the_admission_order(session,
                                                                paged):
    """Each request draws from its own generator, seeded from its seed:
    two admission orders give the same tokens per request, equal to the
    port's B=1 ``generate`` with that seed and temperature."""
    specs = [(_prompt(4 + i, seed=i), 40 + i, 1.0 if i % 2 else 0.7)
             for i in range(4)]
    kw = (dict(page_size=8, n_pages=16, n_rows=2) if paged
          else dict(n_slots=2))

    def serve(order):
        rt = ServingRuntime(session, chunk=3, max_len=16, **kw)
        reqs = {i: rt.submit(specs[i][0], 5, seed=specs[i][1],
                             temperature=specs[i][2]) for i in order}
        done = {c.request_id: c.tokens for c in rt.run()}
        return {i: done[r.id] for i, r in reqs.items()}

    a, b = serve([0, 1, 2, 3]), serve([3, 1, 0, 2])
    for i, (p, seed, temp) in enumerate(specs):
        np.testing.assert_array_equal(a[i], b[i])
        ref = session.generate(torch.as_tensor(p)[None], 5, seed=seed,
                               temperature=temp)[0].numpy()
        np.testing.assert_array_equal(a[i], ref)


def test_full_and_partial_hits_sample_like_a_miss(session):
    """Full hits draw their first token from the cached logits with the
    request's own generator, partial hits after the suffix pass: both give
    the unshared ``generate`` chain, sampled or greedy."""
    cases = [(BASE, 0.0), (BASE, 1.0), (BASE + [7, 3, 9], 0.0),
             (BASE + [5], 0.8)]
    rt = ServingRuntime(session, chunk=4, max_len=32, page_size=8,
                        n_pages=24, n_rows=4)
    for i, (p, temp) in enumerate(cases):
        r = rt.submit(p, 5, seed=50 + i, temperature=temp)
        np.testing.assert_array_equal(_served(rt, [r])[0], _ref(session, r))
    pool = next(iter(rt.pools.values()))
    assert (pool.stats["full_hits"], pool.stats["partial_hits"]) == (1, 2)
    pool.alloc.check()


# --- host bookkeeping, both packages ----------------------------------------

def _serving(pkg):
    if pkg == "jax":
        import repro.serving as mod
    else:
        import repro_torch.serving as mod
    return mod


PKGS = pytest.mark.parametrize("pkg", ["jax", "torch"])


@PKGS
@given(st.lists(st.integers(0, 999), min_size=1, max_size=80),
       st.integers(1, 12))
@settings(deadline=None, max_examples=25)
def test_allocator_churn_never_leaks_or_double_frees(pkg, ops, n_pages):
    """Random alloc/retain/release churn: the free list and the refcounts
    always partition the pages, and releasing every holder drains the pool
    back to fully free."""
    alloc = _serving(pkg).PageAllocator(n_pages)
    holders = {}
    for op in ops:
        act = op % 3
        if act == 0 and alloc.available() >= 1:
            alloc.commit(1)
            pid = alloc.alloc(1)[0]
            assert pid not in holders
            holders[pid] = 1
        elif act in (1, 2) and holders:
            pid = sorted(holders)[op % len(holders)]
            if act == 1:
                alloc.retain(pid)
                holders[pid] += 1
            else:
                alloc.release(pid)
                holders[pid] -= 1
                if holders[pid] == 0:
                    del holders[pid]
        alloc.check()
        assert alloc.refs == holders
    for pid, n in list(holders.items()):
        for _ in range(n):
            alloc.release(pid)
    alloc.check()
    assert len(alloc.free) == n_pages
    assert not alloc.refs and alloc.committed == 0


@PKGS
def test_allocator_rejects_double_free_and_overcommit(pkg):
    mod = _serving(pkg)
    alloc = mod.PageAllocator(4)
    alloc.commit(2)
    a, b = alloc.alloc(2)
    alloc.release(a)
    with pytest.raises(KeyError):
        alloc.release(a)                       # double free
    with pytest.raises(mod.PagesExhausted):
        alloc.commit(4)
    alloc.release(b)
    with pytest.raises(RuntimeError):
        alloc.alloc(1)                         # draws past the commitment


def test_prefix_digests_equal_across_packages():
    """The prefix cache keys a prompt by the same running blake2b in both
    packages (so their caches hit on the same prompts)."""
    from repro.serving.pages import _prefix_digests as jd
    from repro_torch.serving.pages import _prefix_digests as td
    p = _prompt(9, seed=3)
    assert td(p) == jd(p) and len(td(p)) == 9


@PKGS
def test_queue_edf_order(pkg):
    mod = _serving(pkg)
    q = mod.RequestQueue(max_size=8)
    a = q.put(mod.Request(_prompt(4), 4, slo_ms=None, arrival_ts=1.0))
    b = q.put(mod.Request(_prompt(4), 4, slo_ms=50.0, arrival_ts=2.0))
    c = q.put(mod.Request(_prompt(4), 4, slo_ms=5000.0, arrival_ts=3.0))
    assert [q.pop().id for _ in range(3)] == [b.id, c.id, a.id]


@PKGS
def test_queue_fifo_among_equals_and_bounds(pkg):
    mod = _serving(pkg)
    q = mod.RequestQueue(max_size=2)
    a = q.put(mod.Request(_prompt(4), 4, arrival_ts=1.0))
    b = q.put(mod.Request(_prompt(4), 4, arrival_ts=2.0))
    with pytest.raises(mod.QueueFull):
        q.put(mod.Request(_prompt(4), 4))
    assert q.rejections == {"full": 1}
    assert q.pop().id == a.id and q.pop().id == b.id
    with pytest.raises(IndexError):
        q.pop()


@PKGS
def test_request_validation(pkg):
    mod = _serving(pkg)
    r = mod.Request(np.ones((1, 5), np.int64), 3)
    assert r.prompt.shape == (5,) and r.total_len == 8
    with pytest.raises(ValueError):
        mod.Request(np.ones(4, np.int64), 0)


@PKGS
def test_scheduler_forms_and_holds(pkg):
    """Micro-batches from the compiled policy table: nothing without a
    queue or free slots, at most the queue, a plan key of a profiled
    mode."""
    import types
    if pkg == "jax":
        from repro.core.policy import AdaptivePolicy
        from repro.profiling import ProfileContext, SweepSpec, get_backend
    else:
        from repro_torch.core.policy import AdaptivePolicy
        from repro_torch.profiling import (ProfileContext, SweepSpec,
                                           get_backend)
    mod = _serving(pkg)
    pm = get_backend("simulated").profile(ProfileContext(), SweepSpec())
    sess = types.SimpleNamespace(policy=AdaptivePolicy(pm), bandwidth=400.0,
                                 objective="latency")
    sched = mod.AdaptiveScheduler(sess, max_wait_ms=1e9)
    q = mod.RequestQueue()
    assert sched.next_batch(q, free_slots=4) is None
    for i in range(3):
        q.put(mod.Request(_prompt(4), 4, arrival_ts=float(i)))
    assert sched.next_batch(q, free_slots=0) is None
    mb = sched.next_batch(q, free_slots=8, idle=True, now=100.0)
    assert mb is not None and 1 <= len(mb.requests) <= 3
    assert mb.exec_key.split("@")[0] in ("local", "prism")
    assert sched.history[-1] is mb


@PKGS
def test_straggler_hook_skips_tiny_workloads_and_emits(pkg):
    mod = _serving(pkg)
    hook = mod.StragglerHook(n_devices=8, seg_size=64)
    for _ in range(10):
        ev = hook.observe([1.0] * 7 + [9.0], n_tokens=256)
    assert ev is None and not hook.events
    hook = mod.StragglerHook(n_devices=4, seg_size=2)
    for _ in range(10):
        ev = hook.observe([1.0, 1.0, 1.0, 3.0], n_tokens=64)
    assert ev is not None and ev.stragglers == [3]
    assert sum(ev.partitions) == 64
    assert ev.partitions[3] == min(ev.partitions)


@PKGS
def test_fault_hook_consumes_each_death_once(pkg):
    mod = _serving(pkg)
    hook = mod.FaultHook(nodes=["n0", "n1"], timeout_s=1e9)
    assert hook.check() is None
    hook.monitor.fail("n1")
    assert hook.check() == ["n1"]
    assert hook.check() is None                # consumed
    ev = hook.record(["n1"], requeued=2)
    assert (ev.dead, ev.survivors, ev.requeued) == (["n1"], 1, 2)


# --- the port's runtime ------------------------------------------------------

class _Mesh:
    """Stand-in for an elastic mesh manager: devices + drop(ids)."""

    def __init__(self, devices):
        self.devices = list(devices)

    def drop(self, ids, rebuild=True):
        self.devices = [d for d in self.devices if d not in ids]


def test_fault_hook_requeues_and_completes(session):
    from repro_torch.serving import FaultHook
    mesh = _Mesh(["n0", "n1", "n2"])
    hook = FaultHook(nodes=["n0", "n1", "n2"], timeout_s=1e9,
                     mesh_manager=mesh)
    rt = ServingRuntime(session, n_slots=2, chunk=3, max_len=24,
                        fault_hook=hook)
    reqs = [rt.submit(_prompt(4, seed=i), 6, seed=i) for i in range(3)]
    rt.step()                                  # admit + first chunk
    hook.monitor.fail("n1")                    # heartbeat miss mid-flight
    rt.run()
    assert rt.stats["requeued"] >= 1
    assert [e.dead for e in hook.events] == [["n1"]]
    assert mesh.devices == ["n0", "n2"]
    done = {c.request_id: c.tokens for c in rt.completions}
    for req in reqs:                           # re-admitted: still exact
        np.testing.assert_array_equal(done[req.id], _ref(session, req))


def test_fault_requeue_bypasses_queue_bound(session):
    from repro_torch.serving import FaultHook
    hook = FaultHook(nodes=["n0"], timeout_s=1e9)
    rt = ServingRuntime(session, n_slots=2, chunk=3, max_len=24,
                        queue_size=1, fault_hook=hook)
    rt.submit(_prompt(4, seed=0), 6, seed=0)
    rt.step()
    rt.queue.put(Request(_prompt(4, seed=9), 6, seed=9))   # fill the bound
    hook.monitor.fail("n0")
    rt.run()                                   # must not raise QueueFull
    assert len(rt.completions) == 2


def test_drive_applies_backpressure_and_stays_exact(session):
    rt = ServingRuntime(session, n_slots=2, chunk=3, max_len=24,
                        queue_size=1)
    prompts = [_prompt(4, seed=i) for i in range(5)]
    comps = rt.drive(prompts, [0.0] * 5, 6)    # burst >> queue bound
    got = {c.request_id: c.tokens for c in comps}
    assert len(got) == 5
    for i, rid in enumerate(sorted(got)):
        ref = session.generate(torch.as_tensor(prompts[i])[None], 6,
                               seed=i)[0].numpy()
        np.testing.assert_array_equal(got[rid], ref)


def test_stats_snapshot_is_a_copy_and_drain_empties(session):
    rt = ServingRuntime(session, n_slots=2, chunk=3, max_len=24,
                        queue_size=1)
    rt.submit(_prompt(4, seed=0), 6)
    with pytest.raises(QueueFull):
        rt.submit(_prompt(4, seed=1), 6)
    snap = rt.stats_snapshot()
    assert snap["queue_depth"] == 1 and snap["rejections"] == {"full": 1}
    snap["steps"] = 999
    assert rt.stats["steps"] == 0
    rt2 = ServingRuntime(session, n_slots=2, chunk=3, max_len=24)
    reqs = [rt2.submit(_prompt(4, seed=i), 6, seed=i) for i in range(3)]
    rt2.step()                                 # 2 in flight + 1 queued
    assert {r.id for r in rt2.drain_requests()} == {r.id for r in reqs}
    assert len(rt2.queue) == 0 and rt2.idle


def test_runtime_feeds_straggler_hook_and_rejects_oversized(session):
    from repro_torch.serving import StragglerHook
    hook = StragglerHook(n_devices=2, seg_size=2)
    rt = ServingRuntime(session, n_slots=2, chunk=3, max_len=16,
                        straggler_hook=hook)
    rt.submit(_prompt(4), 5)
    rt.run()
    assert hook.chunk_walls_ms and hook.mitigator._seen == 0
    with pytest.raises(ValueError, match="max_len"):
        rt.submit(_prompt(12), 8)


def test_prime_slot_forwards_prefill_mode(session):
    prompt = _prompt(4)[None]
    session.prime_slot(prompt, total_len=16)
    session.prime_slot(prompt, total_len=16, prefill_mode="scan")
    fns = session._serve_execs[session.plans["local"]]
    modes = {fn.prefill_mode for k, fn in fns.items()
             if k[0] == "prefill" and k[1] == 16}
    assert modes == {"single_pass", "scan"}


def test_slot_pool_rejects_unsupported_families():
    sess = TSession.from_config("vit-base-16", reduced={"n_layers": 1},
                                device="cpu")
    with pytest.raises(NotImplementedError,
                       match="slot pool.*audio, vlm and vit"):
        sess.init_slot_pool(2, 16)
    with pytest.raises(NotImplementedError, match="slot pool"):
        sess.prime_slot(np.zeros((1, 4), np.int32), total_len=16)


def test_admission_bounded_by_pages_not_rows(session):
    rt = ServingRuntime(session, chunk=4, max_len=32, page_size=8,
                        n_pages=4, n_rows=8)   # 4 pages, 8 rows
    reqs = [rt.submit(_prompt(5, seed=i), 4, seed=i) for i in range(5)]
    for req, out in zip(reqs, _served(rt, reqs)):
        np.testing.assert_array_equal(out, _ref(session, req))
    assert rt.stats["max_concurrent"] <= 2
    pool = next(iter(rt.pools.values()))
    pool.alloc.check()
    assert pool.alloc.committed == 0


def test_paged_pool_rejects_oversized_and_occupied(session):
    plan = session.plans["local"]
    pool = PagedPool(session, plan, 2, n_pages=4, page_size=4, max_pages=4)
    big = Request(_prompt(4), n_new=20, arrival_ts=0.0)
    with pytest.raises(ValueError):
        pool.admit(big, 0, "local", False, 0.0)
    small = Request(_prompt(4), n_new=2, arrival_ts=0.0)
    pool.admit(small, 0, "local", False, 0.0)
    with pytest.raises(RuntimeError, match="occupied"):
        pool.admit(small, 0, "local", False, 0.0)
    with pytest.raises(ValueError):
        PagedPool(session, plan, 2, n_pages=2, page_size=4, max_pages=4)


def test_hit_under_eviction_pressure_falls_back_to_miss(session):
    base = list(_prompt(13, seed=21))
    rt = ServingRuntime(session, chunk=4, max_len=24, page_size=8,
                        n_pages=3, n_rows=2)
    _served(rt, [rt.submit(base, 4, seed=0)])
    pool = next(iter(rt.pools.values()))
    r1 = rt.submit(base + [7, 3, 9], 4, seed=1)
    np.testing.assert_array_equal(_served(rt, [r1])[0], _ref(session, r1))
    assert pool.prefix.evictions >= 1
    assert pool.stats["prefix_misses"] == 2
    pool.alloc.check()
    assert pool.alloc.committed == 0


def test_failed_miss_admission_rolls_back(session, monkeypatch):
    """An exception after the reservation (the prefill failing) returns the
    reservation and every page; the pool serves afterwards."""
    pool = PagedPool(session, session.plans["local"], 2, n_pages=8,
                     page_size=4, max_pages=8)
    monkeypatch.setattr(pool.session, "prime_slot",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("device fell over")))
    req = Request(_prompt(5, seed=1), n_new=4, arrival_ts=0.0)
    with pytest.raises(RuntimeError, match="device fell over"):
        pool.admit(req, 0, "local", False, 0.0)
    pool.alloc.check()
    assert pool.alloc.committed == 0 and not pool.alloc.refs
    assert pool.slots[0] is None and (pool.page_table == pool.trash).all()
    monkeypatch.undo()
    assert pool.admit(req, 0, "local", False, 0.0) is pool.slots[0]
    pool.evict(0)
    pool.alloc.check()
    assert pool.alloc.committed == 0


def test_failed_hit_admission_keeps_cache_consistent(session, monkeypatch):
    base = list(_prompt(13, seed=33))
    rt = ServingRuntime(session, chunk=4, max_len=32, page_size=8,
                        n_pages=16, n_rows=4)
    _served(rt, [rt.submit(base, 4, seed=0)])
    pool = next(iter(rt.pools.values()))
    entry = next(iter(pool.prefix.entries.values()))
    refs0 = dict(pool.alloc.refs)
    monkeypatch.setattr(pool.session, "suffix_paged",
                        lambda *a, **k: (_ for _ in ()).throw(
                            RuntimeError("boom")))
    req = Request(np.asarray(base + [5], np.int32), n_new=4, arrival_ts=0.0)
    with pytest.raises(RuntimeError, match="boom"):
        pool.admit(req, pool.free_slots()[0], "local", False, 0.0)
    pool.alloc.check()
    assert pool.alloc.refs == refs0 and pool.alloc.committed == 0
    assert pool.prefix.entries.get(entry.digest) is entry


def test_evicting_all_requests_frees_every_page(session):
    rt = ServingRuntime(session, chunk=4, max_len=32, page_size=8,
                        n_pages=16, n_rows=4)
    base = list(_prompt(13, seed=3))
    for i, p in enumerate([base, base + [1, 2], list(_prompt(6, seed=4))]):
        _served(rt, [rt.submit(p, 4, seed=i)])
    pool = next(iter(rt.pools.values()))
    pool.alloc.check()
    for digest in list(pool.prefix.entries):
        pool.prefix.evict_entry(digest)
    pool.alloc.check()
    assert len(pool.alloc.free) == pool.n_pages
    assert not pool.alloc.refs and pool.alloc.committed == 0
    assert (pool.page_table == pool.trash).all()


def test_cold_pages_roundtrip_within_codec_tolerance(session):
    """Quantize a prefix entry's pages cold and revive them: contents come
    back within the int8 codec's per-vector tolerance (the bound the JAX
    package's test uses), and the revived entry serves a hit."""
    rt = ServingRuntime(session, chunk=4, max_len=32, page_size=8,
                        n_pages=16, n_rows=4, cold_horizon=1)
    _served(rt, [rt.submit(list(_prompt(12, seed=9)), 4, seed=0)])
    pool = next(iter(rt.pools.values()))
    entry = next(iter(pool.prefix.entries.values()))
    idx = torch.as_tensor(entry.pages())
    before = {n: leaf[:, idx].clone() for n, leaf in pool.pool["kv"].items()}
    pool.prefix.clock += 2
    pool._sweep_cold()
    assert entry.cold and entry.payloads is not None
    pool.alloc.check()
    revived = pool._revive(entry)
    assert revived is not None and not revived.cold
    idx2 = torch.as_tensor(revived.pages())
    for n, leaf in pool.pool["kv"].items():
        b, a = before[n].numpy(), leaf[:, idx2].numpy()
        tol = np.abs(b).max(axis=-1, keepdims=True) * 0.02 + 1e-6
        assert np.all(np.abs(a - b) <= tol)
    r1 = rt.submit(list(_prompt(12, seed=9)), 4, seed=5)
    assert _served(rt, [r1])[0].shape == (4,)
    assert pool.stats["dequant_pages"] == len(entry.pages())


# --- the launcher ------------------------------------------------------------

def test_serve_launcher_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--mode", "local", "--requests", "6", "--batch", "2", "--tokens",
         "4", "--prompt-len", "8", "--pages", "48", "--page-size", "8"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "SERVE OK"
    assert any(ln.startswith("pages: occupancy") for ln in lines)
    assert "served 6 requests" in out.stdout


def test_serve_launcher_refuses_a_partitioned_mode(capsys):
    """The launcher's modes are the JAX launcher's (prism, local,
    adaptive): its parser refuses ``--mode voltage`` before anything
    runs, since the serving pools hold one partition."""
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit) as exit_info:
        main(["--device", "cpu", "--mode", "voltage"])
    assert exit_info.value.code == 2
    assert "invalid choice: 'voltage'" in capsys.readouterr().err
