"""The port's exporters (``repro_torch.obs.export``) and the launchers'
``--trace``/``--metrics`` on the CPU, mirroring the export part of the
JAX package's ``tests/test_obs.py``.  Each host-only test runs on both
packages (``pkg``); the parity tests feed both the same spans, metrics
and seeded chaos fleet and compare the JSONL files, the Prometheus text,
the breakdown line and the rendered span forests byte for byte.
"""
import importlib

import numpy as np
import pytest

PKGS = ("repro", "repro_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _spans(pkg):
    """One closed request tree, a runtime-level span and an open span."""
    obs = _mod(pkg, "obs")
    tr = obs.Tracer(name="t", clock=lambda: 0.0)
    root = tr.record("request", start=0.0, end=1.0, trace_id="req:2",
                     kind="serving", worker="a")
    tr.record("queue_wait", start=0.0, end=0.25, trace_id="req:2",
              parent_id=root.span_id, worker="a")
    tr.record("decode", start=0.25, end=1.0, trace_id="req:2",
              parent_id=root.span_id, worker="a", kind="fleet", tokens=3)
    tr.record("decode_chunk", start=0.3, end=0.4, trace_id="run:t",
              kind="serving", steps=4)
    tr.start("prefill", at=2.0, trace_id="req:3")    # still open
    return tr


def _registries(pkg):
    obs = _mod(pkg, "obs")
    a, b = obs.MetricsRegistry(), obs.MetricsRegistry()
    a.counter("rpc.client.frames_in", {"worker": "w0"}).inc(5)
    a.gauge("fleet.router.alive", help="live workers").set(2)
    h = b.histogram("serving.chunk_ms")
    for v in (2.0, 3.5, 40.0):
        h.observe(v)
    b.observe_bandwidth("codec.decode_bw_bytes_per_s", 1.5e9, "measured",
                        codec="int8", worker="w0")
    return a, b


@pytest.mark.parametrize("pkg", PKGS)
def test_spans_jsonl_roundtrip(tmp_path, pkg):
    export = _mod(pkg, "obs.export")
    tr = _spans(pkg)
    path = str(tmp_path / "spans.jsonl")
    assert export.write_spans_jsonl(tr.spans, path) == 5
    back = export.read_spans_jsonl(path)
    assert sorted(s.trace_id for s in back) == ["req:2", "req:2", "req:2",
                                                "req:3", "run:t"]
    dec = next(s for s in back if s.name == "decode")
    assert dec.attrs == {"tokens": 3}
    assert dec.duration_ms == pytest.approx(750.0)
    assert next(s for s in back if s.name == "prefill").open


@pytest.mark.parametrize("pkg", PKGS)
def test_prometheus_text_merges_registries(pkg):
    export = _mod(pkg, "obs.export")
    text = export.prometheus_text(*_registries(pkg))
    assert '# TYPE rpc_client_frames_in counter' in text
    assert 'rpc_client_frames_in{worker="w0"} 5' in text
    assert "# HELP fleet_router_alive live workers" in text
    assert "serving_chunk_ms_count 3" in text
    assert "serving_chunk_ms_p99 39.27" in text       # interpolated


@pytest.mark.parametrize("pkg", PKGS)
def test_format_breakdown_counts_request_leaves(pkg):
    export = _mod(pkg, "obs.export")
    spans = [s for s in _spans(pkg).spans if s.trace_id.startswith("req:")]
    line = export.format_breakdown(spans, wall_ms=1000.0)
    assert line.startswith("stages: queue_wait 250.0ms | decode 750.0ms")
    assert "= 100% of 1000.0ms wall" in line
    assert export.format_breakdown([]) == "stages: (no closed spans)"


def test_exports_equal_the_jax_packages(tmp_path):
    """Same spans and metrics → the same JSONL file, Prometheus text and
    breakdown line from both packages."""
    out = {}
    for pkg in PKGS:
        export = _mod(pkg, "obs.export")
        tr = _spans(pkg)
        path = tmp_path / f"{pkg}.jsonl"
        export.write_spans_jsonl(tr.spans, str(path))
        req = [s for s in tr.spans if s.trace_id.startswith("req:")]
        out[pkg] = (path.read_bytes(),
                    export.prometheus_text(*_registries(pkg)),
                    export.format_breakdown(req, wall_ms=1000.0))
    assert out["repro"] == out["repro_torch"]


def _chaos_forest(pkg, seed):
    """A seeded SimWorker chaos fleet on the virtual clock (the JAX
    package's ``_chaos_trace``) → its rendered span forest, its placement
    explanations and the controller's log."""
    obs = _mod(pkg, "obs")
    fleet = _mod(pkg, "fleet")
    chaos = _mod(pkg, "chaos")
    prof = _mod(pkg, "profiling")
    hw_mod = _mod(pkg, "profiling.hardware")
    Request = _mod(pkg, "serving.queue").Request
    RetryPolicy = _mod(pkg, "runtime.fault").RetryPolicy
    reg = fleet.DeviceRegistry(heartbeat_timeout_s=1e9)
    for name in ("a", "b"):
        hw = fleet.scaled_hardware(hw_mod.JETSON_ORIN_NANO, 1.0)
        pm = prof.get_backend("simulated").profile(
            prof.ProfileContext(hardware=hw), prof.SweepSpec())
        reg.add(fleet.SimWorker(name, perfmap=pm, hardware=hw))
    tracer = obs.Tracer(name="fleet", clock=lambda: 0.0)
    router = fleet.FleetRouter(reg, clock=lambda: 0.0,
                               retry=RetryPolicy(max_retries=3,
                                                 backoff_base_s=0.01))
    router.attach_tracer(tracer)
    rng = np.random.RandomState(seed)
    arrivals = np.cumsum(rng.exponential(1 / 25.0, 10))
    reqs = [Request(prompt=rng.randint(0, 64, 8), n_new=2,
                    arrival_ts=float(arrivals[i])) for i in range(10)]
    ctl = chaos.ChaosController(reg, chaos.FaultSchedule.parse(
        "kill:b@0.05; revive:b@0.40; straggle:a@0.10:2.5"))
    out = router.drive_virtual(reqs, events=ctl.events())
    assert len(out["completions"]) + len(out["shed"]) == 10
    forest = "\n\n".join("\n".join(obs.tree_lines(tracer.trace(tid)))
                         for tid in tracer.trace_ids())
    placed = [(r.worker, r.reason, [s.explain() for s in r.scores])
              for r in router.placements]
    return forest, placed, ctl.log


def test_chaos_trace_deterministic():
    """Same seed, same schedule → byte-identical span forest in the port;
    another seed differs."""
    a, b = _chaos_forest("repro_torch", 3), _chaos_forest("repro_torch", 3)
    assert a == b
    assert a[0] != _chaos_forest("repro_torch", 4)[0]


def test_chaos_trace_equals_the_jax_packages():
    """The same seeded chaos fleet in both packages: the same span forest,
    placements (scored rankings included) and chaos log."""
    assert _chaos_forest("repro_torch", 3) == _chaos_forest("repro", 3)


def test_serve_launcher_trace_and_metrics(tmp_path, capsys):
    """``repro_torch.launch.serve --trace PATH --metrics`` writes the span
    JSONL and prints the breakdown line and the Prometheus dump."""
    from repro_torch.launch import serve
    from repro_torch.obs import read_spans_jsonl
    path = tmp_path / "serve.jsonl"
    serve.main(["--device", "cpu", "--mode", "local", "--requests", "3",
                "--batch", "2", "--tokens", "3", "--prompt-len", "6",
                "--trace", str(path), "--metrics"])
    out = capsys.readouterr().out
    spans = read_spans_jsonl(str(path))
    assert f"trace: {len(spans)} spans -> {path}" in out
    assert {"request", "prefill", "decode"} <= {s.name for s in spans}
    assert "stages: " in out and "% of " in out
    assert "# TYPE serving_steps counter" in out
    assert out.rstrip().endswith("SERVE OK")


def test_fleet_launcher_trace_and_metrics(tmp_path, capsys):
    """The virtual-time fleet launcher under chaos with ``--trace`` and
    ``--metrics``: the request trees land in the JSONL file and the
    router's and workers' registries in the dump."""
    from repro_torch.launch import fleet
    from repro_torch.obs import read_spans_jsonl
    path = tmp_path / "fleet.jsonl"
    fleet.main(["--device", "cpu", "--requests", "8", "--tokens", "4",
                "--chaos", "kill:edge-b@0.2;revive:edge-b@1",
                "--trace", str(path), "--metrics"])
    out = capsys.readouterr().out
    spans = read_spans_jsonl(str(path))
    assert spans and any(s.trace_id.startswith("req:") for s in spans)
    assert "stages: " in out
    assert "fleet_router_routed" in out and "fleet_worker_served" in out
    assert "FLEET OK" in out
