"""The port's profiling slice held against the JAX package on the CPU:

* the ``measured`` backend's arithmetic: with the timer stubbed in both
  packages to the same per-plan times, the two perf maps are equal key for
  key (entries within 1e-9 relative, the same meta, the same stamp);
* a real CPU run of the port's backend (the JAX package's own test of it,
  ``tests/test_profiling.py``) and its ``ValueError`` without executables;
* a measured profile across 2 gloo ranks (ViT and llama under ``local``,
  ``voltage`` and ``prism``): one map on every rank, charged at the rank
  with the most compute, with the measured staged seconds taken out of
  it; with the seq-group timings stubbed, each partitioned entry equals
  the JAX package's transport model composed with that compute;
* ``models.registry.input_specs`` against the reference's shapes;
* the session's trace hooks: ``from_trace`` (both packages on the same
  spans, and the port on its own tracer, fed back to ``calibrate``), the
  modeled staging/wire children and the ``generate`` span;
* both deprecation shims, the H100 presets' dict round trip and the
  timing helpers.
"""
import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

from repro.api import ExecutionPlan as JPlan
from repro.api import InferenceSession as JSession
from repro_torch.api import ExecutionPlan as TPlan
from repro_torch.api import InferenceSession as TSession
from repro_torch.core.perfmap import PerfKey, PerfMap
from repro_torch.profiling import (H100_GLOO_STAGED, H100_SXM,
                                   JETSON_ORIN_NANO, PRESET_HARDWARE,
                                   PRESET_LINKS, HardwareProfile,
                                   ProfileContext, SweepSpec, get_backend)

TINY = SweepSpec(batches=(1, 2), crs=(9.9,), bandwidths_mbps=(400.0,),
                 warmup_runs=1)
STUB_SPEC = SweepSpec(batches=(1, 2, 8), crs=(9.9,),
                      bandwidths_mbps=(200.0, 400.0, 900.0))
REDUCED = {"dtype": "float32", "vocab_size": 64}


def _plans(pkg_plan):
    """local, prism_sim at CR 9.9 and an int8-codec prism_sim plan."""
    return [pkg_plan.local(), pkg_plan.prism_sim(L=4, cr=9.9),
            pkg_plan("prism_sim", 0.0, 0, "seq", 2, codec="int8")]


# per-plan forward seconds at B = 1, growing with the batch like a device
STUB_BASE = {"local": 2.0e-3, "prism@9.9": 1.5e-3, "prism+int8": 1.7e-3}


def _stub_timer(execs):
    """A stand-in for ``timeit_*``: the plan of ``fn`` (looked up in
    ``execs``) and the batch of the inputs fix the seconds it returns."""
    names = {id(fn): key for key, fn in execs.items()}

    def timeit(fn, inputs, iters=10, warmup=2, **_):
        lead = next(iter(inputs.values()))
        B = int(lead.shape[0])
        return STUB_BASE[names[id(fn)]] * (1.0 + 0.4 * (B - 1))
    return timeit


def _j_hardware(profile):
    from repro.profiling import HardwareProfile as JH
    from repro.profiling import LinkProfile as JL
    kind = JH if isinstance(profile, HardwareProfile) else JL
    return kind.from_dict(profile.to_dict())


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen1.5-32b",
                                  "vit-base-16"])
@pytest.mark.parametrize("presets", ["jetson", "h100"])
def test_measured_map_equals_the_jax_packages(monkeypatch, arch, presets):
    import repro.utils.timing as jtiming
    import repro_torch.utils.timing as ttiming
    reduced = REDUCED if arch != "vit-base-16" else {"dtype": "float32"}
    js = JSession.from_config(arch, plans=_plans(JPlan), reduced=reduced)
    ts = TSession.from_config(arch, plans=_plans(TPlan), reduced=reduced,
                              device="cpu")
    monkeypatch.setattr(jtiming, "timeit_jax", _stub_timer(js._execs))
    monkeypatch.setattr(ttiming, "timeit_torch", _stub_timer(ts._execs))
    jkw = tkw = {}
    if presets == "h100":
        tkw = dict(hardware=H100_SXM, link=H100_GLOO_STAGED)
        jkw = {k: _j_hardware(v) for k, v in tkw.items()}
    pj = js.profile(STUB_SPEC, backend="measured", **jkw)
    pt = ts.profile(STUB_SPEC, backend="measured", **tkw)
    ej = {k.encode(): e for k, e in pj.entries()}
    et = {k.encode(): e for k, e in pt.entries()}
    assert set(ej) == set(et) and len(et) == 3 * (1 + 3 + 3)
    for key, want in ej.items():
        got = et[key]
        assert got.meta == want.meta
        for f in ("total_ms", "per_sample_ms", "per_sample_j", "compute_ms",
                  "staging_ms", "comm_ms"):
            assert getattr(got, f) == pytest.approx(getattr(want, f),
                                                    rel=1e-9, abs=0)
    assert pt.hardware.to_dict() == pj.hardware.to_dict()
    assert pt.link.to_dict() == pj.link.to_dict()
    dj, dt = js.decide(8, 400.0), ts.decide(8, 400.0)
    assert (dj.mode, dj.cr, dj.codec) == (dt.mode, dt.cr, dt.codec)


@pytest.mark.parametrize("arch,reduced", [
    ("vit-base-16", True),
    ("llama3.2-1b", {"vocab_size": 64}),
])
def test_measured_backend_profiles_session_arch(arch, reduced):
    """The JAX package's test of its backend, on the port on the CPU: the
    session's own arch and only the plans it registered."""
    sess = TSession.from_config(arch, reduced=reduced, device="cpu",
                                plans=[TPlan.local(),
                                       TPlan.prism_sim(L=4, cr=9.9)])
    pm = sess.profile(TINY, backend="measured", iters=1, warmup=1)
    assert len(pm) == 4                      # (local + prism@9.9) × 2 batches
    for b in (1, 2):
        local = pm.get(PerfKey("local", b, 0.0, 0.0))
        prism = pm.get(PerfKey("prism", b, 9.9, 400.0))
        assert local is not None and prism is not None
        assert local.meta["measured"] and local.meta["arch"] == sess.cfg.name
        assert local.total_ms > 0 and prism.total_ms > 0
        assert prism.staging_ms > 0 and prism.comm_ms > 0
    assert pm.hardware == JETSON_ORIN_NANO
    backend = get_backend("measured")
    assert backend.last_scale > 0
    assert sorted(backend.last_times) == ["local", "prism@9.9"]
    assert all(sorted(t) == [1, 2] and min(t.values()) > 0
               for t in backend.last_times.values())
    assert sess.decide(2, 400.0).mode in ("local", "prism")


def test_measured_backend_requires_executables():
    with pytest.raises(ValueError, match="session's own executables"):
        get_backend("measured").profile(ProfileContext(), TINY)


def test_single_process_plans_profile_as_before_with_a_seq_group_up(
        tmp_path):
    """With a seq group initialised in this process, a session of
    single-process plans (``local``, ``prism_sim``) takes the
    single-process arithmetic: no entry says ``per_rank``."""
    from repro_torch.core.seq_group import (destroy_seq_group,
                                            has_seq_group, init_seq_group)
    single = TSession.from_config("llama3.2-1b", reduced={"vocab_size": 64},
                                  device="cpu",
                                  plans=[TPlan.local(),
                                         TPlan.prism_sim(L=4, cr=9.9)])
    init_seq_group(0, 1, str(tmp_path / "store"))
    try:
        pm = single.profile(TINY, backend="measured", iters=1, warmup=1)
    finally:
        destroy_seq_group()
    assert not has_seq_group("seq")
    assert len(pm) == 4
    assert not any("per_rank" in e.meta for _, e in pm.entries())


# Two ranks' stubbed timings of a partitioned call at B = 1 (forward,
# staged seconds, staged calls), growing with the batch like STUB_BASE:
# this process waits long at the collectives, the other rank computes more
# but finishes first, so the charged rank is the other one.
STUB_RANKS = ((10.0e-3, 6.0e-3, 12), (9.5e-3, 2.0e-3, 12))


class _StubGroup:
    """A 2-rank seq group whose staged timings come from STUB_RANKS: the
    stub timer books this rank's, ``all_gather_object`` adds the other
    rank's numbers for the same calls."""
    world_size = 2

    def __init__(self):
        from repro_torch.core.seq_group import GatherStats
        self.stats = GatherStats()

    def reset_stats(self):
        from repro_torch.core.seq_group import GatherStats
        self.stats = GatherStats()

    def all_gather_object(self, mine):
        other = {}
        for key, (t, st) in mine.items():
            if st is None:
                other[key] = (t * 0.5, None)
            else:
                grow = t / STUB_RANKS[0][0]
                ft, fs, n = STUB_RANKS[1]
                other[key] = (ft * grow, (fs * grow, n))
        return [mine, other]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "vit-base-16"])
@pytest.mark.parametrize("presets", ["jetson", "h100"])
def test_per_rank_entries_equal_the_jax_packages_model(monkeypatch, arch,
                                                       presets):
    """With the seq-group timings stubbed, each partitioned entry is the
    JAX package's transport model (``model.distributed``, or
    ``exchange_cost`` for a codec plan) at the same P, L, codec, batch
    and bandwidth, composed with ``per_dev_ms = (t − staged)·scale +
    coord`` of the rank with the most compute; the local anchor and the
    scale are the single-process ones."""
    import repro_torch.profiling.backends as tbackends
    import repro_torch.utils.timing as ttiming
    from repro.profiling import sweep as jsweep
    from repro.transport import exchange_cost
    reduced = REDUCED if arch != "vit-base-16" else {"dtype": "float32"}
    plans = [TPlan.local(), TPlan.voltage(seq_shards=2),
             TPlan.prism(L=4, cr=9.9, seq_shards=2),
             TPlan("prism", 9.9, 4, "seq", 2, codec="int8")]
    ts = TSession.from_config(arch, plans=plans, reduced=reduced,
                              device="cpu")
    group = _StubGroup()
    parted = {key for key, plan in ts.plans.items() if plan.seq_shards > 1}
    assert len(parted) == 3
    for key in parted:              # warm-up calls run nothing
        ts._execs[key] = lambda batch: None
    monkeypatch.setattr(tbackends, "_plan_seq_group",
                        lambda plan: group if plan is not None
                        and plan.seq_shards > 1 else None)
    names = {id(fn): key for key, fn in ts._execs.items()}

    def timeit(fn, inputs, iters=10, warmup=2, **_):
        B = int(next(iter(inputs.values())).shape[0])
        grow = 1.0 + 0.4 * (B - 1)
        if names[id(fn)] not in parted:
            return 2.0e-3 * grow
        t, staged, n = STUB_RANKS[0]
        group.stats.seconds, group.stats.calls = staged * grow, n
        return t * grow
    monkeypatch.setattr(ttiming, "timeit_torch", timeit)
    tkw = jkw = {}
    if presets == "h100":
        tkw = dict(hardware=H100_SXM, link=H100_GLOO_STAGED)
        jkw = {k: _j_hardware(v) for k, v in tkw.items()}
    pt = ts.profile(STUB_SPEC, backend="measured", **tkw)
    js = JSession.from_config(arch, plans=[JPlan.local()], reduced=reduced)
    jctx = js.profile_context(**jkw)
    workload = jsweep.workload_from_config(jctx.cfg, 0)
    model = jctx.edge_model(workload)
    B0 = STUB_SPEC.batches[0]
    scale = (model.local(B0)["compute_ms"] / 1e3) / 2.0e-3
    assert get_backend("measured").last_scale == pytest.approx(scale,
                                                               rel=1e-12)
    n_entries = 0
    for B in STUB_SPEC.batches:
        grow = 1.0 + 0.4 * (B - 1)
        want_local = model.pack(B, 2.0e-3 * grow * scale * 1e3, 0.0, 0.0,
                                boards=1)
        got = pt.get(PerfKey("local", B, 0.0, 0.0))
        assert got.total_ms == pytest.approx(want_local["total_ms"],
                                             rel=1e-9)
        ft, fs, n = STUB_RANKS[1]
        per_dev = ((ft - fs) * grow * scale * 1e3
                   + model.c.coord_overhead_ms)
        for key in sorted(parted):
            plan = ts.plans[key]
            for bw in STUB_SPEC.bandwidths_mbps:
                e = pt.get(plan.to_perf_key(B, bw))
                if plan.codec:
                    terms = exchange_cost(
                        plan.codec, n_tokens=workload.n_tokens,
                        d_model=workload.d_model,
                        bytes_per_el=workload.bytes_per_el, batch=B, P=2,
                        n_layers=workload.n_layers, bandwidth_mbps=bw,
                        profile=jctx.link, link=plan.link or "staged",
                        L=plan.L, param=plan.codec_param)
                    want = model.pack(B, per_dev + terms["decode_ms"],
                                      terms["staging_ms"], terms["comm_ms"],
                                      boards=2)
                    assert e.meta["wire_bytes"] == terms["wire_bytes"]
                else:
                    rm = model.distributed(B, bw, 2,
                                           L=plan.L if plan.L > 0 else None)
                    want = model.pack(B, per_dev, rm["staging_ms"],
                                      rm["comm_ms"], boards=2)
                for f in ("total_ms", "per_sample_ms", "per_sample_j",
                          "compute_ms", "staging_ms", "comm_ms"):
                    assert getattr(e, f) == pytest.approx(want[f], rel=1e-9,
                                                          abs=0), (key, f)
                m = e.meta
                assert (m["seq_group"], m["per_rank"], m["staged_calls"]) \
                    == (2, True, n)
                assert m["forward_ms_measured"] == pytest.approx(
                    ft * grow * 1e3, rel=1e-12)
                assert m["staged_ms_measured"] == pytest.approx(
                    fs * grow * 1e3, rel=1e-12)
                n_entries += 1
    assert n_entries == len(STUB_SPEC.batches) * 3 * 3


# A measured profile on 2 gloo ranks: reduced f32 ViT (197 tokens, L 20)
# and llama (32 tokens, L 4) under local, voltage and prism.  DELAY slows
# every staged call of the group by a known sleep inside its timed window.
# On a machine loaded by the test suite's other workers the compute of a
# forward varied by ~30 ms between two spawns, and the staged seconds grew
# ~35 ms past calls × DELAY, with 3 (llama) or 5 (ViT) staged calls a
# forward; DELAY and LOAD keep calls × DELAY / 4 several times that.
SEQ_JOBS = {
    "vit-base-16": dict(reduced={"dtype": "float32"}, n_tokens=197, L=20),
    "llama3.2-1b": dict(reduced={"dtype": "float32", "vocab_size": 64},
                        n_tokens=32, L=4),
}
DELAY = 0.15
# LOAD adds compute to the last rank alone: it sleeps before each staged
# call opens, and the other rank waits for it inside its own window.
LOAD = 0.15
_SEQ_RUNS = {}


def _seq_profile(arch, delay=0.0, load=0.0):
    import _torch_ranks
    from repro_torch.core.seq_group import spawn
    if (arch, delay, load) not in _SEQ_RUNS:
        job = dict(SEQ_JOBS[arch], arch=arch, bw=400.0, batches=(1, 2),
                   iters=3, decide=(1, 8), delay=delay, load=load)
        _SEQ_RUNS[arch, delay, load] = spawn(_torch_ranks.profile_seq, 2,
                                             job, timeout=120)
    return _SEQ_RUNS[arch, delay, load]


def _partitioned_entries(doc):
    return {k: e for k, e in json.loads(doc)["entries"].items()
            if k.split("|")[0] in ("voltage", "prism")}


@pytest.mark.parametrize("arch", sorted(SEQ_JOBS))
def test_measured_profile_over_a_seq_group_is_one_map(arch):
    """Every rank profiles SPMD and returns the same map, decisions and
    dispatched plan; each partitioned entry's meta says it was charged
    per rank at P 2, with the measured staged ms and calls beside the
    modeled staging."""
    runs = _seq_profile(arch)
    docs = [r[0] for r in runs]
    assert docs[0] == docs[1]
    assert runs[0][1] == runs[1][1]             # last_times, slowest rank
    assert runs[0][2] == runs[1][2] and runs[0][3] == runs[1][3]
    parts = _partitioned_entries(docs[0])
    assert len(parts) == 2 * 2                 # (voltage, prism) × 2 batches
    for key, e in parts.items():
        m = e["meta"]
        assert m["measured"] and m["per_rank"] and m["seq_group"] == 2
        assert m["staged_calls"] > 0 and m["staged_ms_measured"] > 0
        assert 0 < m["staged_ms_measured"] < m["forward_ms_measured"]
        assert e["staging_ms"] > 0 and e["comm_ms"] > 0    # modeled
    local = json.loads(docs[0])["entries"]["local|1|0|0"]
    assert "per_rank" not in local["meta"]


@pytest.mark.parametrize("arch", sorted(SEQ_JOBS))
def test_measured_profile_charges_compute_without_the_staged_seconds(arch):
    """Slowing every staged call by DELAY puts at least calls × DELAY into
    ``staged_ms_measured`` (every sleep lies inside a staged window; the
    unslowed run's waits on the other rank may shrink under it) while
    the compute charged (forward less staged) stays within noise of the
    unslowed run."""
    fast = _partitioned_entries(_seq_profile(arch)[0][0])
    slow = _partitioned_entries(_seq_profile(arch, DELAY)[0][0])
    assert fast.keys() == slow.keys()
    for key in fast:
        mf, ms = fast[key]["meta"], slow[key]["meta"]
        added = mf["staged_calls"] * DELAY * 1e3
        assert ms["staged_calls"] == mf["staged_calls"]
        assert ms["staged_ms_measured"] >= added
        grown = ms["staged_ms_measured"] - mf["staged_ms_measured"]
        assert 0.5 * added <= grown <= 1.5 * added
        cf = mf["forward_ms_measured"] - mf["staged_ms_measured"]
        cs = ms["forward_ms_measured"] - ms["staged_ms_measured"]
        assert abs(cs - cf) < 0.25 * added


@pytest.mark.parametrize("arch", sorted(SEQ_JOBS))
def test_measured_profile_charges_the_rank_with_the_most_compute(arch):
    """With compute added to the last rank alone (LOAD before each of
    its staged calls), both ranks' forwards end together, the other
    rank's staged seconds hold its wait, and the compute charged (forward
    less staged) is the loaded rank's: at least calls × LOAD, and about
    that much above the unloaded run's."""
    base = _partitioned_entries(_seq_profile(arch)[0][0])
    runs = _seq_profile(arch, load=LOAD)
    assert runs[0][0] == runs[1][0]
    loaded = _partitioned_entries(runs[0][0])
    assert base.keys() == loaded.keys()
    for key in base:
        mb, ml = base[key]["meta"], loaded[key]["meta"]
        added = ml["staged_calls"] * LOAD * 1e3
        cl = ml["forward_ms_measured"] - ml["staged_ms_measured"]
        cb = mb["forward_ms_measured"] - mb["staged_ms_measured"]
        assert cl >= added
        assert cl - cb >= 0.5 * added


SPEC_CASES = [(arch, kind) for arch in ("llama3.2-1b", "internlm2-1.8b",
                                        "qwen1.5-32b")
              for kind in ("train", "prefill", "decode")] + [
    ("vit-base-16", "prefill")] + [
    (arch, kind) for arch in ("whisper-large-v3", "llama-3.2-vision-11b")
    for kind in ("train", "prefill")]


@pytest.mark.parametrize("arch,kind", SPEC_CASES)
def test_input_specs_match_the_jax_packages(arch, kind):
    from repro.configs import get_config as jget
    from repro.configs.base import ShapeSpec as JShape
    from repro.models import registry as jreg
    from repro_torch.configs import get_config as tget
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import registry as treg
    want = jreg.input_specs(jget(arch), JShape("s", 48, 3, kind))
    got = treg.input_specs(tget(arch), ShapeSpec("s", 48, 3, kind))
    assert {k: (tuple(s.shape), str(s.dtype)) for k, s in want.items()} == {
        k: (tuple(s.shape), str(s.dtype).split(".")[1])
        for k, s in got.items()}


def test_input_specs_of_unported_families_raise():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import registry
    cfg = dataclasses.replace(get_config("llama3.2-1b"), family="rnn")
    with pytest.raises(NotImplementedError, match="has no input specs"):
        registry.input_specs(cfg, ShapeSpec("s", 8, 1, "prefill"))


# --- trace hooks -----------------------------------------------------------

@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_from_trace_rebuilds_dispatch_records(pkg):
    """The JAX package's own test of ``from_trace``, run on both."""
    if pkg == "jax":
        from repro.api.session import from_trace
        from repro.obs import Tracer
    else:
        from repro_torch.api import from_trace
        from repro_torch.obs import Tracer
    tr = Tracer(name="s", clock=lambda: 0.0)
    tr.record("dispatch", start=1.0, end=1.1, kind="session",
              trace_id="t", exec_key="prism4", batch=4,
              bandwidth_mbps=200.0, codec="int8", wire_bytes=123,
              substituted=True)
    tr.record("dispatch", start=0.0, end=0.5, kind="serving",
              trace_id="t")                       # wrong kind: skipped
    tr.start("dispatch", kind="session", trace_id="t",
             exec_key="local", batch=1)           # open: skipped
    tr.record("dispatch", start=0.0, end=0.5, kind="session",
              trace_id="t")                       # no exec_key: skipped
    recs = from_trace(tr.spans)
    assert len(recs) == 1
    r = recs[0]
    assert r.exec_key == "prism4" and r.batch == 4
    assert r.wall_ms == pytest.approx(100.0)
    assert r.decision is None and r.substituted
    assert r.codec == "int8" and r.wire_bytes == 123
    assert r.bandwidth_mbps == pytest.approx(200.0)


def _traced(**kw):
    """A profiled port session with a tracer attached."""
    from repro_torch.obs import Tracer
    sess = TSession.from_config("llama3.2-1b", reduced=REDUCED, device="cpu",
                                plans=[TPlan.local(),
                                       TPlan.prism_sim(L=4, cr=9.9)], **kw)
    sess.profile(backend="simulated")
    sess.tracer = Tracer(name="session")
    return sess


@pytest.fixture
def traced():
    return _traced()


def _tokens(B, T, vocab, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, vocab, (B, T)).astype(np.int32))


def test_session_tracer_feeds_calibrate(traced):
    """Each dispatch leaves one ``dispatch`` span; ``from_trace`` rebuilds
    the session's own records from them, and ``calibrate(records=...)``
    folds them in without moving the history cursor."""
    from repro_torch.api import from_trace
    traced.observe_bandwidth(400.0)
    for B in (1, 8):
        traced.dispatch({"tokens": _tokens(B, 16, traced.cfg.vocab_size)})
    spans = [s for s in traced.tracer.spans if s.name == "dispatch"]
    assert len(spans) == 2 and traced.tracer.current() is None
    recs = from_trace(traced.tracer.spans)
    for rec, own in zip(recs, traced.history):
        assert (rec.batch, rec.exec_key, rec.codec, rec.wire_bytes,
                rec.substituted, rec.extrapolated) == (
            own.batch, own.exec_key, own.codec, own.wire_bytes,
            own.substituted, own.extrapolated)
        assert rec.bandwidth_mbps == pytest.approx(own.bandwidth_mbps)
        assert rec.wall_ms == pytest.approx(own.wall_ms, rel=1e-6)
    rep = traced.calibrate(records=recs)
    assert rep.records == 2 and rep.updated == 2
    assert traced.calibrate().records == 2   # own history still unread


def test_dispatch_span_has_modeled_transport_children():
    """A dispatch that moves bytes gets its decision's modeled staging and
    wire as children, marked ``modeled``."""
    traced = _traced(allow_modes=("prism",))
    traced.dispatch({"tokens": _tokens(8, 16, traced.cfg.vocab_size)})
    sp = next(s for s in traced.tracer.spans if s.name == "dispatch")
    assert sp.attrs["exec_key"] == "prism@9.9" and sp.attrs["wire_bytes"] > 0
    kids = [s for s in traced.tracer.spans if s.parent_id == sp.span_id]
    assert [k.name for k in kids] == ["staging", "wire"]
    assert all(k.attrs["modeled"] and k.kind == "transport" for k in kids)
    d = traced.history[-1].decision.expected
    assert kids[0].duration_ms == pytest.approx(d.staging_ms)
    assert kids[1].duration_ms == pytest.approx(d.comm_ms)


def test_generate_span(traced):
    out = traced.generate(_tokens(2, 5, traced.cfg.vocab_size), 3)
    assert out.shape == (2, 3)
    sp = [s for s in traced.tracer.spans if s.name == "generate"]
    assert len(sp) == 1 and not sp[0].open and sp[0].kind == "session"
    assert sp[0].attrs == {"plan": "local", "n_new": 3}


# --- deprecation shims ------------------------------------------------------

def test_profile_measured_shim_warns_and_forwards(monkeypatch):
    """The JAX package's test of its legacy free function, on the port."""
    from repro_torch.core.profiler import profile_measured
    calls = {}

    def fake_profile(self, spec=None, **kw):
        calls.update(kw, spec=spec, device=self.device.type)
        return PerfMap()
    monkeypatch.setattr(TSession, "profile", fake_profile)
    with pytest.warns(DeprecationWarning, match="backend='measured'"):
        pm = profile_measured(TINY, device="cpu")
    assert isinstance(pm, PerfMap)
    assert calls["backend"] == "measured" and calls["spec"] == TINY
    assert calls["device"] == "cpu"
    with pytest.warns(DeprecationWarning, match="n_layers"):
        profile_measured(TINY, device="cpu", n_layers=12)
    with pytest.raises(TypeError, match="unexpected keyword"):
        profile_measured(TINY, device="cpu", depth=3)


def test_session_profile_measured_kwarg_deprecated():
    sess = TSession.from_config("llama3.2-1b", reduced={"vocab_size": 64},
                                device="cpu")
    with pytest.warns(DeprecationWarning, match="backend='measured'"):
        pm = sess.profile(TINY, measured=True, iters=1, warmup=1)
    assert all(e.meta["measured"] for _, e in pm.entries())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sess.profile(TINY, backend="measured", iters=1, warmup=1)


# --- presets and timing ----------------------------------------------------

@pytest.mark.parametrize("preset", [H100_SXM, H100_GLOO_STAGED])
def test_h100_presets_round_trip(preset, tmp_path):
    kind = type(preset)
    back = kind.from_dict(json.loads(json.dumps(preset.to_dict())))
    assert back == preset
    table = PRESET_HARDWARE if kind is HardwareProfile else PRESET_LINKS
    assert table[preset.name] is preset
    assert "H100" in preset.description and "700 W" in preset.description
    # a map stamped with the presets saves and loads
    pm = get_backend("simulated").profile(
        ProfileContext(hardware=H100_SXM, link=H100_GLOO_STAGED), TINY)
    pm.save(str(tmp_path / "h100.json"))
    loaded = PerfMap.load(str(tmp_path / "h100.json"))
    assert (loaded.hardware, loaded.link) == (H100_SXM, H100_GLOO_STAGED)


def test_a_map_profiled_by_the_jax_package_loads(tmp_path):
    from repro.api import profile_simulated
    path = str(tmp_path / "jax.json")
    profile_simulated(spec=TINY).save(path)
    pm = PerfMap.load(path)
    assert pm.hardware == JETSON_ORIN_NANO and len(pm) > 0
    assert PRESET_LINKS[pm.link.name] == pm.link


def test_timeit_torch_on_the_cpu_takes_the_median():
    from repro_torch.utils import Timer, timeit_torch
    calls = []
    t = timeit_torch(lambda x: calls.append(x), torch.zeros(2), iters=5,
                     warmup=2)
    assert len(calls) == 7 and t >= 0.0
    timer = Timer()
    with timer.scope("a"):
        pass
    assert len(timer.records["a"]) == 1 and timer.mean_ms("a") >= 0.0
