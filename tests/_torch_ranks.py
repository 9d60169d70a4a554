"""Rank bodies for the port's multi-rank CPU tests.

``repro_torch.core.seq_group.spawn`` runs each of these in fresh processes
that import them by name, so they live in a module of their own that
imports neither JAX nor the JAX package (a rank starts faster without
them).  Inputs arrive as numpy arrays; results go back as numpy arrays.
"""
import numpy as np
import torch

from repro_torch.core.exchange import (ExchangeConfig, ExchangeMode,
                                       exchange_attention)
from repro_torch.core.seq_group import get_seq_group


def _part(a, rank, world):
    n = a.shape[1] // world
    return torch.from_numpy(np.ascontiguousarray(a[:, rank * n:(rank + 1) * n]))


def _xcfg(c, world):
    return ExchangeConfig(ExchangeMode(c["mode"]), seq_axis="seq",
                          seq_shards=world, L=c.get("L", 0),
                          codec=c.get("codec", ""),
                          codec_param=c.get("codec_param", 0),
                          overlap_chunks=c.get("overlap_chunks", 0))


def exchange_cases(rank, world, cases):
    """Each case: global q/k/v (and kv_mask) plus exchange settings (mode,
    causal, softcap, window, scale, L, codec, codec_param,
    overlap_chunks); this rank runs ``exchange_attention`` on its
    partition → per case (output, payload bytes, meta bytes, calls, the
    global K and V handed to ``kv_sink`` or None)."""
    group = get_seq_group("seq")
    outs = []
    for c in cases:
        group.reset_stats()
        mask = c.get("kv_mask")
        seen = []
        out = exchange_attention(
            _part(c["q"], rank, world), _part(c["k"], rank, world),
            _part(c["v"], rank, world), _xcfg(c, world), causal=c["causal"],
            logit_softcap=c.get("softcap"), window=c.get("window"),
            scale=c.get("scale"),
            kv_mask=None if mask is None else _part(mask, rank, world),
            kv_sink=lambda *kv: seen.append([_np(t) for t in kv]))
        st = group.stats
        outs.append((out.numpy(), st.payload_bytes, st.meta_bytes, st.calls,
                     seen[0] if seen else None))
    return outs


def vit_logits(rank, world, np_params, reduced, images, plans, dispatch_bw):
    """Reduced ViT in the port from the JAX weights: logits of ``images``
    under each plan key in ``plans`` (built with P = world), and the plan
    ``dispatch`` picks after this rank observed ``dispatch_bw[rank]``."""
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.configs import get_config
    from repro_torch.models.bridge import params_from_numpy
    cfg = get_config("vit-base-16").reduced(**reduced)
    made = {"local": ExecutionPlan.local(),
            "voltage": ExecutionPlan.voltage(seq_shards=world)}
    for key in plans:
        if key.startswith("prism"):
            L = int(key.split(":")[1])
            made[key] = ExecutionPlan.prism(L=L, cr=197 / (L * world),
                                            seq_shards=world)
    session = InferenceSession.from_config(
        "vit-base-16", plans=[made[k] for k in plans], reduced=reduced,
        params=params_from_numpy(np_params, cfg), device="cpu",
        initial_bandwidth_mbps=dispatch_bw[rank])
    batch = {"images": torch.from_numpy(images)}
    logits = {k: session.run(made[k].key, batch).numpy() for k in plans}
    session.profile(backend="simulated")
    session.dispatch(batch)
    rec = session.history[-1]
    return logits, rec.exec_key, rec.decision.mode, session.bandwidth


def cache_block(a, rank, world, axis):
    """Rank's block of ``a`` along ``axis`` after padding it to a multiple
    of ``world`` (the sharded decode cache's layout)."""
    S = a.shape[axis]
    Sp = -(-S // world)
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, Sp * world - S)
    a = np.pad(a, pad)
    return np.ascontiguousarray(np.take(a, np.arange(rank * Sp,
                                                     (rank + 1) * Sp), axis))


def _np(t):
    return t.detach().numpy()


def sharded_decode_cases(rank, world, cases):
    """Each case: q, the global K/V cache [B, S, ...], cache_len, softcap
    and optionally the means of every block; this rank calls
    ``decode_attention_sharded`` with its block → outputs, and the bytes
    and calls its merges took."""
    from repro_torch.core.exchange import decode_attention_sharded
    group = get_seq_group("seq")
    outs = []
    for c in cases:
        group.reset_stats()
        xcfg = ExchangeConfig(ExchangeMode(c["mode"]), seq_axis="seq",
                              seq_shards=world)
        means = c.get("means")
        clen = c["cache_len"]
        out = decode_attention_sharded(
            torch.from_numpy(c["q"]),
            torch.from_numpy(cache_block(c["k"], rank, world, 1)),
            torch.from_numpy(cache_block(c["v"], rank, world, 1)),
            torch.from_numpy(clen) if isinstance(clen, np.ndarray) else clen,
            xcfg, logit_softcap=c.get("softcap"),
            k_means=None if means is None else torch.from_numpy(means[0]),
            v_means=None if means is None else torch.from_numpy(means[1]))
        st = group.stats
        outs.append((_np(out), st.merge_bytes, st.calls))
    return outs


def lm_seq(rank, world, job):
    """``job["sharded"]`` through ``sharded_decode_cases``, then a reduced
    dense LM from the JAX weights under ``voltage`` and ``prism`` across
    the ranks of the group: forward logits (global, and
    ``last_only``) with what the gathers moved, decode steps against the
    sharded cache (from the port's own cache, and each step from a given
    int8 cache), greedy and sampled ``generate``, and the plan
    ``dispatch`` picks after this rank observed ``job["bw"][rank]``."""
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.bridge import params_from_numpy
    group = get_seq_group("seq")
    res = {"sharded": sharded_decode_cases(rank, world, job["sharded"])}
    for label, a in job["archs"].items():
        arch = a["arch"]
        cfg = get_config(arch).reduced(**a["reduced"])
        plans = {"voltage": ExecutionPlan.voltage(seq_shards=world),
                 "prism": ExecutionPlan.prism(L=job["L"], cr=1.0,
                                              seq_shards=world)}
        session = InferenceSession.from_config(
            arch, plans=[ExecutionPlan.local(), *plans.values()],
            reduced=a["reduced"], params=params_from_numpy(a["params"], cfg),
            device="cpu", initial_bandwidth_mbps=job["bw"][rank])
        r = res[label] = {}
        toks = torch.from_numpy(job["tokens"])
        for name, plan in plans.items():
            group.reset_stats()
            logits = session.run(plan.key, {"tokens": toks})
            st = group.stats
            r[f"fwd/{name}"] = (_np(logits), st.payload_bytes, st.meta_bytes,
                                st.output_bytes, st.calls)
            with torch.inference_mode():
                last, _ = tfm.forward_lm(session.params, {"tokens": toks},
                                         cfg, plan.to_exchange_config(),
                                         last_only=True)
            r[f"last/{name}"] = _np(last)
        prompt = torch.from_numpy(job["prompt"])
        n_new = job["n_new"]
        for name, mode in (("voltage", "auto"), ("prism", "auto"),
                           ("prism", "single_pass")):
            group.reset_stats()
            out = session.generate(prompt, n_new, plan=plans[name],
                                   prefill_mode=mode)
            r[f"gen/{name}/{mode}"] = (_np(out), group.stats.cache_bytes)
        r["sampled"] = [_np(session.generate(prompt, n_new,
                                             plan=plans["voltage"], seed=s,
                                             temperature=0.8))
                        for s in (11, 11, 12)]
        with torch.inference_mode():
            for name, plan in plans.items():
                xcfg = plan.to_exchange_config()
                steps = job["decode_tokens"]
                cache = tfm.init_decode_cache(cfg, steps.shape[0],
                                              job["decode_len"], xcfg=xcfg)
                got = []
                for t in range(steps.shape[1]):
                    lg, cache = tfm.decode_step(
                        session.params,
                        {"tokens": torch.from_numpy(steps[:, t:t + 1])},
                        cache, t, cfg, xcfg)
                    got.append(_np(lg))
                r[f"decode/{name}"] = (np.concatenate(got, axis=1),
                                       {k: _np(v) for k, v in
                                        cache["kv"].items()})
            if "caches" in a:      # each step from the given cache
                xcfg = plans["voltage"].to_exchange_config()
                got = []
                for t, full in enumerate(a["caches"]):
                    cache = {"kv": {k: torch.from_numpy(
                        cache_block(v, rank, world, 2))
                        for k, v in full.items()}}
                    lg, cache = tfm.decode_step(
                        session.params,
                        {"tokens": torch.from_numpy(
                            job["decode_tokens"][:, t:t + 1])},
                        cache, t, cfg, xcfg)
                    got.append((_np(lg), {k: _np(v) for k, v in
                                          cache["kv"].items()}))
                r["decode/int8"] = got
        session.profile(backend="simulated")
        session.dispatch({"tokens": toks})
        rec = session.history[-1]
        r["dispatch"] = (rec.exec_key, rec.decision.mode, session.bandwidth)
    return res


def model_plans(rank, world, job):
    """A reduced model from the JAX weights under each of ``job["plans"]``
    (label → ``ExecutionPlan`` fields, built with P = world): the forward's
    logits and what its staged calls moved (payload, meta, calls); for an
    LM also greedy ``generate`` under each of ``job["generate"]``."""
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models.bridge import params_from_numpy
    group = get_seq_group("seq")
    cfg = get_config(job["arch"]).reduced(**job["reduced"])
    session = InferenceSession.from_config(
        job["arch"], reduced=job["reduced"], device="cpu",
        params=params_from_numpy(job["params"], cfg))
    fwd = registry.forward_fn(cfg)
    plans = {label: ExecutionPlan(seq_axis="seq", seq_shards=world, **kw)
             for label, kw in job["plans"].items()}
    batch = {k: torch.from_numpy(v) for k, v in job["batch"].items()}
    res = {}
    for label, plan in plans.items():
        group.reset_stats()
        with torch.inference_mode():
            logits = fwd(session.params, batch, plan.to_exchange_config())[0]
        st = group.stats
        res[label] = (_np(logits), st.payload_bytes, st.meta_bytes, st.calls)
    for label in job.get("generate", ()):
        res[f"gen/{label}"] = _np(session.generate(
            torch.from_numpy(job["prompt"]), job["n_new"],
            plan=plans[label]))
    return res


def gemma_seq(rank, world, job):
    """The reduced gemma2 (windowed local/global layers) from the JAX
    weights across the group: ``job["exchange"]`` through
    ``exchange_cases``; ``forward_lm`` under each of ``job["forwards"]``
    (label → (plan fields, tokens name)) with what its staged calls moved
    and its ``last_only`` logits; decode steps, each from the given JAX
    cache (``job["caches"]``, its blocks taken by this rank); and greedy
    ``generate`` under ``voltage`` and ``prism`` with the cache bytes its
    prefill gathered, and under ``prism`` with the forced single-pass
    prefill of ``job["long_prompt"]`` (the halo's prefill)."""
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.bridge import params_from_numpy
    group = get_seq_group("seq")
    res = {"exchange": exchange_cases(rank, world, job["exchange"])}
    cfg = get_config("gemma2-27b").reduced(**job["reduced"])
    session = InferenceSession.from_config(
        "gemma2-27b", reduced=job["reduced"], device="cpu",
        params=params_from_numpy(job["params"], cfg))
    plans = {label: ExecutionPlan(seq_axis="seq", seq_shards=world, **kw)
             for label, (kw, _) in job["forwards"].items()}
    for label, (_, name) in job["forwards"].items():
        xcfg = plans[label].to_exchange_config()
        toks = torch.from_numpy(job["tokens"][name])
        with torch.inference_mode():
            group.reset_stats()
            logits = tfm.forward_lm(session.params, {"tokens": toks}, cfg,
                                    xcfg)[0]
            st = group.stats
            moved = (st.payload_bytes, st.meta_bytes, st.calls)
            last = tfm.forward_lm(session.params, {"tokens": toks}, cfg,
                                  xcfg, last_only=True)[0]
        res[f"fwd/{label}"] = (_np(logits), *moved, _np(last))
    steps = job["decode_tokens"]
    with torch.inference_mode():
        for label in ("voltage", "prism"):
            xcfg = plans[label].to_exchange_config()
            got = []
            for t, full in enumerate(job["caches"]):
                cache = {half: {k: torch.from_numpy(
                    cache_block(v, rank, world, 2)) for k, v in leaves.items()}
                    for half, leaves in full.items()}
                group.reset_stats()
                lg, cache = tfm.decode_step(
                    session.params,
                    {"tokens": torch.from_numpy(steps[:, t:t + 1])}, cache,
                    t, cfg, xcfg)
                got.append((_np(lg), group.stats.merge_bytes,
                            group.stats.calls))
            res[f"decode/{label}"] = got
    prompt = torch.from_numpy(job["prompt"])
    for label in ("voltage", "prism"):
        group.reset_stats()
        out = session.generate(prompt, job["n_new"], plan=plans[label])
        res[f"gen/{label}"] = (_np(out), group.stats.cache_bytes)
    group.reset_stats()
    out = session.generate(torch.from_numpy(job["long_prompt"]), job["n_new"],
                           plan=plans["prism"], prefill_mode="single_pass")
    res["gen/prism/single_pass"] = (_np(out), group.stats.cache_bytes,
                                    group.stats.payload_bytes)
    return res


def profile_seq(rank, world, job):
    """``session.profile(backend="measured")`` on every rank of a session
    of the reduced ``job["arch"]`` (the port's seeded weights, on
    ``job["device"]``, the CPU by default) holding
    ``local``, ``voltage`` and ``prism`` (``job["L"]``) built with
    P = world; with ``job["delay"]`` > 0 every staged call of the group
    first sleeps that many seconds, inside its timed window, and with
    ``job["load"]`` > 0 the last rank alone sleeps that many seconds
    before each staged call opens its window (compute of that rank only,
    which the other ranks wait for inside their windows).  → (the
    map's JSON, ``last_times``, the decision at each batch of
    ``job["decide"]`` at ``job["bw"]``, the plan ``dispatch`` ran)."""
    import json
    import time

    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.profiling import SweepSpec, get_backend
    group = get_seq_group("seq")
    if job.get("delay"):
        begin = group._begin

        def slowed(t):
            t0 = begin(t)
            time.sleep(job["delay"])
            return t0
        group._begin = slowed
    if job.get("load") and rank == world - 1:
        begin = group._begin

        def loaded(t):
            time.sleep(job["load"])
            return begin(t)
        group._begin = loaded
    n = job["n_tokens"]
    plans = [ExecutionPlan.local(), ExecutionPlan.voltage(seq_shards=world),
             ExecutionPlan.prism(L=job["L"], cr=n / (job["L"] * world),
                                 seq_shards=world)]
    session = InferenceSession.from_config(
        job["arch"], plans=plans, reduced=job["reduced"],
        device=job.get("device", "cpu"), initial_bandwidth_mbps=job["bw"])
    spec = SweepSpec(batches=job["batches"], crs=(n / (job["L"] * world),),
                     bandwidths_mbps=(job["bw"],))
    pm = session.profile(spec, backend="measured", iters=job["iters"],
                         warmup=1)
    times = get_backend("measured").last_times
    decisions = [(d.mode, d.cr, d.codec) for d in
                 (session.decide(b, job["bw"]) for b in job["decide"])]
    B = job["batches"][0]
    if job["arch"] == "vit-base-16":
        batch = {"images": torch.zeros(B, 224, 224, 3)}
    else:
        batch = {"tokens": torch.zeros(B, n, dtype=torch.int32)}
    session.dispatch(batch)
    return (json.dumps(pm.to_doc(), sort_keys=True), times, decisions,
            session.history[-1].exec_key)
