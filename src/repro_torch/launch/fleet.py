"""Fleet launcher: policy-placed routing over a heterogeneous worker fleet.

    PYTHONPATH=src python -m repro_torch.launch.fleet --device cuda \
        [--workers 3] [--requests 24] [--arrival-rate 40] [--tokens 16] \
        [--kill edge-b] [--chaos "kill:edge-b@1;revive:edge-b@3"] \
        [--objective latency|energy] [--explain 3] [--real | --rpc N] \
        [--full] [--trace PATH] [--metrics]

The counterpart of ``repro.launch.fleet``.  Default mode drives
virtual-time workers (:class:`repro_torch.fleet.SimWorker`): three boards
with effective-FLOP/s scaled 1.0 / 0.6 / 0.35 of the Jetson Orin Nano
profile, each placing through its own compiled policy table (the codec
calibration runs on ``--device``).  ``--kill NAME`` fails a worker mid-run
to demonstrate drain + re-route; ``--chaos SPEC`` replays a full
:class:`repro_torch.chaos.FaultSchedule` (``kill``/``revive``/``bw``/
``drift``/``flap``/``stall``/``straggle``/``error`` clauses — see
:meth:`FaultSchedule.parse`) through the same
:class:`~repro_torch.chaos.ChaosController` the tests use.

``--real`` builds two *real* workers (``InferenceSession`` +
``ServingRuntime`` sharing identical params, on ``--device``), serves a
small burst, kills one mid-decode, and verifies the re-routed requests
are token-exact against ``session.generate`` — the fleet-level failover
acceptance check.

``--rpc N`` spawns N *subprocess* workers (``python -m
repro_torch.rpc.worker --device ...``) and drives them over real sockets:
it prints each worker's measured-vs-modeled codec decode-throughput table
(calibration runs on the worker's own process), ``--chaos`` faults are
realized on the wire (kill = SIGKILL, error = truncated frame + hard
close), and the fleet shuts down cleanly on SIGINT.  ``--full`` gives the
``--real`` and ``--rpc`` workers the published widths of ``--arch``.
"""
import argparse


def _make_tracer(args):
    if not (args.trace or args.metrics):
        return None
    from repro_torch.obs import Tracer
    return Tracer(name="fleet")


def _dump_obs(args, tracer, registries, wall_ms=None):
    """Exit-time observability dump shared by all three fleet modes:
    JSONL span file (--trace), per-stage breakdown line, Prometheus text
    (--metrics)."""
    if tracer is None:
        return
    from repro_torch.obs.export import (format_breakdown, prometheus_text,
                                  write_spans_jsonl)
    spans = tracer.spans
    if args.trace:
        write_spans_jsonl(spans, args.trace)
        print(f"trace: {len(spans)} spans "
              f"({len(tracer.trace_ids())} traces) -> {args.trace}")
    # breakdown over request trees only: runtime-level traces
    # (decode_chunk, failover) overlap decode residency and would
    # double-count against the summed request wall
    req_spans = [s for s in spans if s.trace_id.startswith("req:")]
    print(format_breakdown(req_spans, wall_ms=wall_ms))
    if args.metrics:
        uniq = []
        for r in registries:
            if r is not None and all(r is not u for u in uniq):
                uniq.append(r)
        print(prometheus_text(*uniq), end="")


def _sim_main(args):
    import numpy as np

    from repro_torch.fleet import (DeviceRegistry, FleetRejected, FleetRouter,
                             SimWorker, scaled_hardware)
    from repro_torch.profiling.hardware import JETSON_ORIN_NANO
    from repro_torch.serving.queue import Request

    factors = [1.0, 0.6, 0.35, 0.2, 0.1][:max(args.workers, 1)]
    reg = DeviceRegistry(heartbeat_timeout_s=1e9, calibrate_codecs=True,
                         device=args.device)
    if reg.codec_bws:
        bws = ", ".join(f"{n} {bw / 1e9:.2f} GB/s"
                        for n, bw in sorted(reg.codec_bws.items()))
        print(f"measured codec decode throughput: {bws}")
    for i, f in enumerate(factors):
        name = f"edge-{chr(ord('a') + i)}"
        w = reg.add(SimWorker(
            name,
            hardware=scaled_hardware(JETSON_ORIN_NANO, f,
                                     name=f"jetson-{name}"),
            n_slots=args.slots, queue_size=args.queue_size,
            objective=args.objective,
            dispatch_timeout_s=(args.timeout or None)))
        extra = (f", codecs x{f:g}" if w.codec_bws else "")
        print(f"registered {name}: eff x{f:g}{extra}")

    rng = np.random.RandomState(args.seed)
    arrivals = np.cumsum(rng.exponential(1.0 / args.arrival_rate,
                                         args.requests))
    reqs = [Request(prompt=rng.randint(0, 64, args.prompt_len),
                    n_new=args.tokens, seed=i, arrival_ts=float(arrivals[i]))
            for i in range(args.requests)]

    from repro_torch.runtime.fault import RetryPolicy
    router = FleetRouter(reg, objective=args.objective,
                         retry=RetryPolicy(max_retries=args.retries),
                         clock=lambda: 0.0)
    tracer = _make_tracer(args)
    if tracer is not None:
        router.attach_tracer(tracer)
    events = []
    chaos = None
    if args.chaos:
        from repro_torch.chaos import ChaosController, FaultSchedule
        schedule = FaultSchedule.parse(args.chaos)
        chaos = ChaosController(reg, schedule, router=router)
        events.extend(chaos.events())
        print(f"chaos schedule: {len(schedule)} scripted events")
    if args.kill:
        kill_at = float(arrivals[len(arrivals) // 3])
        events.append((kill_at, lambda: reg.fail(args.kill)))
        print(f"will kill {args.kill} at t={kill_at:.2f}s (virtual)")
    out = router.drive_virtual(reqs, events=events)

    for rec in router.placements[:args.explain]:
        print(rec.explain())
    comps = out["completions"]
    lats = [c.latency_ms for c in comps]
    tok_s = out["served_tokens"] / max(out["makespan_s"], 1e-9)
    by_worker = {}
    for c in comps:
        by_worker[c.worker] = by_worker.get(c.worker, 0) + 1
    print(f"served {len(comps)}/{args.requests} requests "
          f"({out['served_tokens']} tokens) in {out['makespan_s']:.2f}s "
          f"virtual -> {tok_s:.1f} tok/s aggregate")
    if lats:
        print(f"latency p50 {np.percentile(lats, 50):.0f} ms  "
              f"p99 {np.percentile(lats, 99):.0f} ms  "
              f"by worker {by_worker}  shed {len(out['shed'])}")
    snap = router.stats_snapshot()
    print(f"router: routed {snap['routed']}  rerouted {snap['rerouted']}  "
          f"rejections {snap['rejections']}  dead {snap['dead']}")
    open_breakers = sorted(n for n, b in snap["breakers"].items()
                           if b["state"] != "closed")
    print(f"resilience: retries {snap['retries']}  "
          f"timeouts {snap['timeouts']}  "
          f"transport errors {snap['transport_errors']}  "
          f"placement retries {snap['placement_retries']}  "
          f"breaker opened {snap['breaker_opened']}x"
          f" (now open: {open_breakers or 'none'})  "
          f"failovers {snap['failovers']}  "
          f"readmissions {snap['readmissions']}  lost {snap['lost']}")
    if chaos is not None:
        print(f"chaos log: {len(chaos.log)} applied events, "
              f"{chaos.pending_faults} never consumed")
    _dump_obs(args, tracer,
              [router.metrics] + [w.metrics for w in reg],
              wall_ms=sum(lats))
    print("FLEET OK")


def _real_main(args):
    import numpy as np

    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.fleet import DeviceRegistry, FleetRouter, WorkerHandle

    def make_session():
        s = InferenceSession.from_config(
            args.arch, reduced=False if args.full else {"vocab_size": 64},
            plans=[ExecutionPlan.local(),
                   ExecutionPlan.prism_sim(L=4, cr=9.9)],
            seed=args.seed, device=args.device)
        s.profile(backend="simulated")
        return s

    # identical params (same config, same seed) — a re-routed request is
    # token-exact on the surviving worker
    s1, s2 = make_session(), make_session()
    max_len = max(64, args.prompt_len + args.tokens)
    reg = DeviceRegistry(heartbeat_timeout_s=1e9)
    reg.add(WorkerHandle("w1", s1, n_slots=4, max_len=max_len))
    reg.add(WorkerHandle("w2", s2, n_slots=4, max_len=max_len))
    router = FleetRouter(reg)
    tracer = _make_tracer(args)
    if tracer is not None:
        router.attach_tracer(tracer)

    rng = np.random.RandomState(args.seed)
    prompts = [rng.randint(0, 64, args.prompt_len) for _ in range(6)]
    placed = router.fanout(prompts, args.tokens)
    for req, rec in placed:
        print(rec.explain() if rec else f"request {req.id} SHED")

    router.step()                     # everyone gets some work in flight
    reg.fail("w1")
    print("killed w1 mid-decode; re-routing its in-flight requests...")
    router.run()

    ok = 0
    for req, _ in placed:
        comp = router.completion_for(req.id)
        ref = s2.generate(np.asarray(req.prompt)[None], req.n_new,
                          seed=req.seed)
        exact = bool(np.array_equal(comp.tokens, ref.cpu().numpy()[0]))
        ok += exact
        print(f"request {req.id}: served by a surviving worker, "
              f"token-exact={exact}")
    snap = router.stats_snapshot()
    print(f"router: routed {snap['routed']}  rerouted {snap['rerouted']}  "
          f"dead {snap['dead']}")
    if ok != len(placed):
        raise SystemExit("FAIL: failover was not token-exact")
    _dump_obs(args, tracer,
              [router.metrics] + [w.metrics for w in reg])
    print("FLEET OK (real workers, token-exact failover)")


def _rpc_main(args):
    """--rpc N: spawn N real subprocess workers (``repro_torch.rpc``), print the
    measured-vs-modeled codec decode-throughput table, drive a short
    real-clock Poisson load (``--chaos`` faults are realized on the wire:
    kills are SIGKILLs, errors are sabotaged sockets), and shut the fleet
    down cleanly — including on Ctrl-C."""
    import signal

    import numpy as np

    from repro_torch.fleet import DeviceRegistry, FleetRouter
    from repro_torch.rpc import RpcWorker
    from repro_torch.runtime.fault import RetryPolicy
    from repro_torch.serving.queue import Request
    from repro_torch.transport.codecs import get_codec

    n = max(args.rpc, 1)
    reg = DeviceRegistry(heartbeat_timeout_s=60.0)
    workers = []
    interrupted = []

    def on_sigint(signum, frame):
        # first Ctrl-C: finish the loop and shut down cleanly; the drive
        # checks the flag through the chaos-free event path below
        interrupted.append(True)
        print("\nSIGINT: draining and shutting the fleet down...")

    old_handler = signal.signal(signal.SIGINT, on_sigint)
    try:
        for i in range(n):
            name = f"rpc-{chr(ord('a') + i)}"
            w = RpcWorker(name, vocab=64, seed=args.seed, n_slots=args.slots,
                          chunk=4, max_len=max(args.prompt_len + args.tokens,
                                               32),
                          queue_size=args.queue_size,
                          hw_scale=[1.0, 0.8, 0.6, 0.5, 0.4][i % 5],
                          arch=args.arch, device=args.device,
                          full=args.full,
                          retry=RetryPolicy(max_retries=args.retries,
                                            backoff_base_s=0.05))
            workers.append(w)
            reg.add(w)
            print(f"spawned {name}: pid {w.proc.pid}, "
                  f"port {w.address[1]}, calibration "
                  f"{'measured' if w.codec_bws_measured else 'estimated'}")
        print(f"{'worker':8s} {'codec':14s} {'measured MB/s':>14s} "
              f"{'modeled MB/s':>13s}")
        for w in workers:
            for cname in sorted(w.codec_bws):
                modeled = type(get_codec(cname)).decode_bw
                print(f"{w.name:8s} {cname:14s} "
                      f"{w.codec_bws[cname] / 1e6:14.1f} "
                      f"{modeled / 1e6:13.1f}")

        router = FleetRouter(reg, objective=args.objective,
                             retry=RetryPolicy(max_retries=args.retries))
        tracer = _make_tracer(args)
        if tracer is not None:
            router.attach_tracer(tracer)
        rng = np.random.RandomState(args.seed)
        n_req = min(args.requests, 24)
        arrivals = np.cumsum(rng.exponential(1.0 / min(args.arrival_rate,
                                                       8.0), n_req))
        reqs = [Request(prompt=rng.randint(0, 64, args.prompt_len),
                        n_new=args.tokens, seed=i,
                        arrival_ts=float(arrivals[i]))
                for i in range(n_req)]
        events = []
        chaos = None
        if args.chaos:
            from repro_torch.chaos import ChaosController, FaultSchedule
            schedule = FaultSchedule.parse(args.chaos)
            chaos = ChaosController(reg, schedule, router=router)
            events.extend(chaos.events())
            print(f"chaos schedule: {len(schedule)} scripted events "
                  "(realized on the wire: kill=SIGKILL, "
                  "error=truncated frame)")
        if interrupted:
            return
        out = router.drive_real(reqs, events=events, timeout_s=600.0)
        comps = out["completions"]
        lats = [c.latency_ms for c in comps]
        by_worker = {}
        for c in comps:
            by_worker[c.worker] = by_worker.get(c.worker, 0) + 1
        tok_s = out["served_tokens"] / max(out["makespan_s"], 1e-9)
        print(f"served {len(comps)}/{n_req} requests "
              f"({out['served_tokens']} tokens) in "
              f"{out['makespan_s']:.2f}s -> {tok_s:.1f} tok/s aggregate")
        if lats:
            print(f"latency p50 {np.percentile(lats, 50):.0f} ms  "
                  f"p99 {np.percentile(lats, 99):.0f} ms  "
                  f"by worker {by_worker}  shed {len(out['shed'])}")
        snap = router.stats_snapshot()
        print(f"router: routed {snap['routed']}  "
              f"rerouted {snap['rerouted']}  lost {snap['lost']}  "
              f"breaker opened {snap['breaker_opened']}x")
        if chaos is not None:
            print(f"chaos log: {len(chaos.log)} applied events, "
                  f"{chaos.pending_faults} never consumed")
        _dump_obs(args, tracer,
                  [router.metrics] + [w.metrics for w in workers],
                  wall_ms=sum(lats))
        print("RPC FLEET OK")
    finally:
        signal.signal(signal.SIGINT, old_handler)
        for w in workers:
            try:
                w.close()
            except Exception:
                w.kill_process()
        live = [w.name for w in workers
                if w.proc is not None and w.proc.poll() is None]
        print(f"shutdown: {len(workers)} workers closed"
              + (f" (still alive: {live})" if live else ""))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=3,
                    help="fleet size (sim mode; eff 1.0/0.6/0.35/...)")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--arrival-rate", type=float, default=40.0,
                    help="Poisson arrival rate, req/s (virtual)")
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--queue-size", type=int, default=8)
    ap.add_argument("--objective", default="latency",
                    choices=["latency", "energy"])
    ap.add_argument("--kill", default="",
                    help="worker name to fail mid-run (e.g. edge-b)")
    ap.add_argument("--chaos", default="",
                    help="fault-schedule spec, e.g. "
                         "'kill:edge-b@1;revive:edge-b@3;"
                         "drift:edge-a@0:600->60:4'")
    ap.add_argument("--retries", type=int, default=3,
                    help="placement retry budget (exponential backoff)")
    ap.add_argument("--timeout", type=float, default=0.0,
                    help="per-dispatch timeout in virtual seconds "
                         "(0 = none)")
    ap.add_argument("--explain", type=int, default=3,
                    help="print the scored ranking of the first N "
                         "placements")
    ap.add_argument("--real", action="store_true",
                    help="two real workers + token-exact failover demo")
    ap.add_argument("--rpc", type=int, default=0, metavar="N",
                    help="spawn N subprocess workers (repro_torch.rpc) and "
                         "drive them over real sockets; --chaos faults "
                         "are realized on the wire")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the workers (and the sim mode's codec "
                         "calibration) run")
    ap.add_argument("--full", action="store_true",
                    help="--real/--rpc: the published widths instead of "
                         "the reduced config (random weights from --seed)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="write the request span trace as JSONL to PATH "
                         "and print a per-stage breakdown at exit "
                         "(works in sim, --real and --rpc modes)")
    ap.add_argument("--metrics", action="store_true",
                    help="dump the unified metrics registries "
                         "(Prometheus text format) at exit")
    args = ap.parse_args(argv)
    if args.rpc:
        _rpc_main(args)
    elif args.real:
        _real_main(args)
    else:
        _sim_main(args)


if __name__ == "__main__":
    main()
