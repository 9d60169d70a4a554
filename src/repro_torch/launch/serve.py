"""Serving launcher: policy-driven request traffic over the port's
`ServingRuntime`.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
        [--arch llama3.2-1b] [--full] [--mode prism|local|adaptive] \
        [--requests 12] [--arrival-rate 50] [--slo-ms 5000] [--batch 8] \
        [--chunk 8] [--tokens 16] [--prompt-len 16] [--bandwidth 400] \
        [--objective latency|energy] [--codec none|int8|int4|topk] \
        [--pages 64 --page-size 16]   # paged KV mode (prefix caching on)
        [--trace spans.jsonl] [--metrics]

The counterpart of ``repro.launch.serve``: requests flow through the
bounded queue → adaptive scheduler (micro-batches formed from the compiled
policy table at ``--bandwidth``/``--objective``) → continuous-batching
decode on the dense slot pool (flash-decode kernel) or, with ``--pages`` /
``--page-size``, on the paged pool (paged flash-decode kernel).
``--mode local`` / ``--mode prism`` pin the plan; ``--mode adaptive`` lets
the policy route.  ``--codec`` registers one more plan, ``prism_sim``
over 2 partitions exchanging through that codec at its default parameter,
and adds the codec to the simulated profiling sweep, so the policy may
pick it (the policy line then names it).  Everything runs on ``--device``
(the card unless ``--device cpu``); the model is the reduced config of
``--arch`` unless ``--full`` asks for the published widths (refused,
naming the sizes, where those weights exceed one device's memory:
deepseek-v2-236b's 472 GB).

PRISM here runs in its single-host simulation form (``prism_sim``), as
in the JAX package's launcher: the serving pools hold one partition (the
JAX package's slot pool is not mesh-sharded), so the modes are the JAX
launcher's ``prism``, ``local`` and ``adaptive``.  Sequence-sharded
generation across the ranks of a seq group is ``InferenceSession.generate``
under a ``voltage`` or ``prism`` plan.  ``--trace PATH`` writes the
request span trace as JSONL and prints the per-stage breakdown at exit;
``--metrics`` dumps the metrics registries as Prometheus text.
"""
import argparse
import time

import numpy as np


def require_one_device_fits(arch: str, device: str) -> None:
    """Raise ``SystemExit`` naming the sizes when ``arch``'s weights at
    their published widths exceed the memory of one ``device`` (the card,
    or the host's for the CPU): the serving pools hold a whole model on
    one device."""
    import os

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import weight_bytes
    need = weight_bytes(get_config(arch))
    if device == "cuda":
        have = torch.cuda.get_device_properties(0).total_memory
        where = torch.cuda.get_device_name(0)
    else:
        have = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        where = "this host"
    if need > have:
        raise SystemExit(
            f"--arch {arch} --full: its weights take {need / 1e9:.1f} GB "
            f"and do not fit one device ({where}: {have / 1e9:.1f} GB); "
            f"serve it without --full (the reduced config), or cut its depth "
            f"for a sharded run as chip_smoke.py's [arch] and [moe-seq] "
            f"phases do")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--full", action="store_true",
                    help="the published widths instead of the reduced "
                         "config (random weights from --seed)")
    ap.add_argument("--mode", default="prism",
                    choices=["prism", "local", "adaptive"])
    ap.add_argument("--batch", type=int, default=8,
                    help="slot-pool size (default request count too)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--L", type=int, default=4)
    ap.add_argument("--codec", default="none",
                    choices=["none", "int8", "int4", "topk"],
                    help="register an extra compressed-exchange plan with "
                         "this repro_torch.transport codec and add it to "
                         "the profiling sweep (the policy may then select "
                         "it)")
    ap.add_argument("--bandwidth", type=float, default=400.0,
                    help="observed link bandwidth (Mbps) for the policy")
    ap.add_argument("--objective", default="latency",
                    choices=["latency", "energy"])
    ap.add_argument("--requests", type=int, default=0,
                    help="number of requests to simulate (default: --batch)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson arrival rate, req/s (0 = burst at t=0)")
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="per-request latency SLO (0 = best effort)")
    ap.add_argument("--slots", type=int, default=0,
                    help="slot-pool size (default: --batch); with --pages/"
                         "--page-size it aliases the page BUDGET instead "
                         "(slots x max_len positions worth of pages)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="decode steps per continuous-batching chunk")
    ap.add_argument("--pages", type=int, default=0,
                    help="paged KV mode: shared pool of this many pages "
                         "(admission bounded by free pages, prefix caching "
                         "on).  0 with --page-size set = --slots' budget")
    ap.add_argument("--page-size", type=int, default=0,
                    help="positions per KV page (paged mode; default 16 "
                         "when only --pages is given)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="paged mode: disable prompt prefix sharing")
    ap.add_argument("--cold-horizon", type=int, default=0,
                    help="paged mode: quantize prefix-cache pages idle for "
                         "this many admissions (LOSSY; 0 = never)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="write the request span trace as JSONL to PATH "
                         "and print a per-stage breakdown at exit")
    ap.add_argument("--metrics", action="store_true",
                    help="dump the unified metrics registry "
                         "(Prometheus text format) at exit")
    args = ap.parse_args(argv)

    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.serving import ServingRuntime

    tracer = None
    if args.trace or args.metrics:
        from repro_torch.obs import Tracer
        tracer = Tracer(name="serve")

    allow = {"local": ("local",), "prism": ("prism",),
             "adaptive": None}[args.mode]
    plans = [ExecutionPlan.local(), ExecutionPlan.prism_sim(L=args.L, cr=9.9)]
    codecs = ()
    if args.codec != "none":
        from repro_torch.transport import get_codec
        plans.append(ExecutionPlan("prism_sim", seq_axis="seq",
                                   seq_shards=2, codec=args.codec,
                                   codec_param=get_codec(
                                       args.codec).default_param))
        codecs = (args.codec,)
    if args.full:
        require_one_device_fits(args.arch, args.device)
    session = InferenceSession.from_config(
        args.arch, reduced=False if args.full else {"vocab_size": 512},
        plans=plans, objective=args.objective, allow_modes=allow,
        initial_bandwidth_mbps=args.bandwidth, device=args.device,
        seed=args.seed)
    from repro_torch.profiling import SweepSpec
    session.profile(SweepSpec(codecs=codecs),
                    backend="simulated")        # paper's offline sweep
    d = session.decide(args.batch)
    print(f"policy: B={args.batch} BW={args.bandwidth:g} Mbps "
          f"[{args.objective}] → {d.mode}"
          + (f" CR={d.cr:g}" if d.cr else "")
          + (f" codec={d.codec}" if d.codec else "")
          + f" ({d.expected.per_sample_ms:.1f} ms/sample expected"
          + (", EXTRAPOLATED batch" if d.extrapolated else "") + ")")

    n_req = args.requests or args.batch
    n_slots = args.slots or args.batch
    rng = np.random.RandomState(args.seed)
    buckets = sorted({max(args.prompt_len // 2, 1), args.prompt_len,
                      args.prompt_len + args.prompt_len // 2})
    lens = [buckets[rng.randint(len(buckets))] for _ in range(n_req)]
    gaps = (rng.exponential(1.0 / args.arrival_rate, n_req)
            if args.arrival_rate > 0 else np.zeros(n_req))
    arrivals = np.cumsum(gaps)
    prompts = [rng.randint(0, session.cfg.vocab_size, t) for t in lens]
    max_len = max(buckets) + args.tokens
    paged = bool(args.pages or args.page_size)
    if paged:
        # --slots stays an alias for the memory budget: n_slots dense rows
        # of max_len positions = the same positions' worth of pages
        rt = ServingRuntime(session, n_slots=n_slots, chunk=args.chunk,
                            max_len=max_len,
                            page_size=args.page_size or None,
                            n_pages=args.pages or None,
                            prefix_cache=not args.no_prefix_cache,
                            cold_horizon=args.cold_horizon or None,
                            tracer=tracer)
        print(f"paged KV pool: {rt.n_pages} pages x {rt.page_size} "
              f"positions ({rt.n_slots} rows, prefix cache "
              f"{'off' if args.no_prefix_cache else 'on'}) on "
              f"{session.device}")
    else:
        rt = ServingRuntime(session, n_slots=n_slots, chunk=args.chunk,
                            max_len=max_len, tracer=tracer)
    session.tracer = tracer

    t_start = time.monotonic()
    comps = rt.drive(prompts, arrivals, args.tokens,
                     slo_ms=args.slo_ms or None, poll_s=0.01)
    dt = time.monotonic() - t_start

    lats = [c.latency_ms for c in comps]
    total_toks = sum(len(c.tokens) for c in comps)
    by_plan = {}
    for c in comps:
        by_plan[c.plan_key] = by_plan.get(c.plan_key, 0) + 1
    print(f"served {len(comps)} requests ({total_toks} tokens) in {dt:.2f}s "
          f"→ {total_toks / dt:.1f} tok/s host wall on {session.device}")
    stats = rt.stats_snapshot()
    print(f"latency p50 {np.percentile(lats, 50):.0f} ms  "
          f"p99 {np.percentile(lats, 99):.0f} ms  "
          f"plans {by_plan}  max concurrent {stats['max_concurrent']}")
    if stats["rejected"]:
        print(f"backpressure: {stats['rejected']} puts shed "
              f"{stats['rejections']}")
    if paged:
        print(f"pages: occupancy {stats['page_occupancy']:.0%} peak-free "
              f"{stats['pages_free']}/{stats['pages_total']}  prefix "
              f"hit-rate {stats['prefix_hit_rate']:.0%} "
              f"({stats['full_hits']} full / {stats['partial_hits']} "
              f"partial, {stats['cow_splits']} COW splits)")
    if args.slo_ms:
        met = sum(1 for c in comps if c.slo_met)
        print(f"SLO {args.slo_ms:g} ms: {met}/{len(comps)} met")
    if tracer is not None:
        from repro_torch.obs.export import (format_breakdown,
                                            prometheus_text,
                                            write_spans_jsonl)
        spans = tracer.spans
        if args.trace:
            write_spans_jsonl(spans, args.trace)
            print(f"trace: {len(spans)} spans -> {args.trace}")
        # reconcile against summed per-request wall (requests overlap, so
        # the host makespan is not the right denominator); request trees
        # only — runtime-level traces (decode_chunk) overlap decode
        # residency and would double-count
        req_spans = [s for s in spans if s.trace_id.startswith("req:")]
        print(format_breakdown(req_spans, wall_ms=sum(lats)))
        if args.metrics:
            print(prometheus_text(rt.metrics, session.metrics), end="")
    print(np.stack([c.tokens for c in comps[:2]]))
    print("SERVE OK")


if __name__ == "__main__":
    main()
