"""Rank bodies for the port's multi-rank CPU tests.

``repro_torch.core.seq_group.spawn`` runs each of these in fresh processes
that import them by name, so they live in a module of their own that
imports neither JAX nor the JAX package (a rank starts faster without
them).  Inputs arrive as numpy arrays; results go back as numpy arrays.
"""
import contextlib

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


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def moe_seq(rank, world, job):
    """The moe family across the group, from the JAX weights:

    * ``job["moe"]``: ``apply_moe`` on this rank's part of each case's
      global x (routed as the whole sequence) → (y, aux, meta bytes,
      calls);
    * ``job["mla"]``: ``exchange_attention_mla`` on this rank's part →
      (out, payload bytes, meta bytes, calls, segment-means calls);
    * ``job["mla_decode"]``: ``mla_decode_attention_sharded`` on this
      rank's block of the latent cache → (out, merge bytes, calls);
    * per arch in ``job["archs"]``: ``forward_lm`` under each plan of
      ``job["plans"]`` (logits, aux, payload, meta, calls, ``last_only``
      logits), decode steps each from the given JAX cache (logits, merge
      bytes, calls), greedy ``generate`` under each plan, and under
      ``voltage`` with the single-pass prefill (tokens, cache bytes)."""
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MoECfg
    from repro_torch.core import exchange as tx
    from repro_torch.kernels import dispatch as kdsp
    from repro_torch.models import transformer as tfm
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.models.moe import apply_moe
    group = get_seq_group("seq")
    res = {"moe": [], "mla": [], "mla_decode": []}
    with torch.inference_mode():
        for c in job["moe"]:
            group.reset_stats()
            y, aux = apply_moe(_tensors(c["params"]),
                               _part(c["x"], rank, world),
                               MoECfg(**c["cfg"]), group=group)
            st = group.stats
            res["moe"].append((_np(y), float(aux), st.meta_bytes, st.calls))
        seg_calls = []
        real = kdsp.segment_means

        def counted(*a, **kw):
            seg_calls.append(1)
            return real(*a, **kw)
        kdsp.segment_means = counted
        try:
            for c in job["mla"]:
                group.reset_stats()
                seg_calls.clear()
                out = tx.exchange_attention_mla(
                    _part(c["q"], rank, world), _part(c["c"], rank, world),
                    _part(c["pe"], rank, world),
                    torch.from_numpy(c["w_uk"]), torch.from_numpy(c["w_uv"]),
                    _xcfg(c, world), causal=True, scale=c["scale"])
                st = group.stats
                res["mla"].append((_np(out), st.payload_bytes, st.meta_bytes,
                                   st.calls, len(seg_calls)))
        finally:
            kdsp.segment_means = real
        for c in job["mla_decode"]:
            group.reset_stats()
            out = tx.mla_decode_attention_sharded(
                torch.from_numpy(c["q_lat"]), torch.from_numpy(c["q_pe"]),
                torch.from_numpy(cache_block(c["c"], rank, world, 1)),
                torch.from_numpy(cache_block(c["pe"], rank, world, 1)),
                c["cache_len"], _xcfg(c, world), scale=c["scale"])
            res["mla_decode"].append((_np(out), group.stats.merge_bytes,
                                      group.stats.calls))
    for label, a in job["archs"].items():
        cfg = get_config(a["arch"]).reduced(**a["reduced"])
        session = InferenceSession.from_config(
            a["arch"], reduced=a["reduced"], device="cpu",
            params=params_from_numpy(a["params"], cfg))
        plans = {name: ExecutionPlan(seq_axis="seq", seq_shards=world, **kw)
                 for name, kw in job["plans"].items()}
        r = res[label] = {}
        toks = torch.from_numpy(job["tokens"])
        with torch.inference_mode():
            for name, plan in plans.items():
                xcfg = plan.to_exchange_config()
                group.reset_stats()
                logits, aux = tfm.forward_lm(session.params, {"tokens": toks},
                                             cfg, xcfg)
                st = group.stats
                moved = (st.payload_bytes, st.meta_bytes, st.calls)
                last = tfm.forward_lm(session.params, {"tokens": toks}, cfg,
                                      xcfg, last_only=True)[0]
                r[f"fwd/{name}"] = (_np(logits), float(aux), *moved,
                                    _np(last))
                steps = job["decode_tokens"]
                got = []
                for t, full in enumerate(a["caches"]):
                    cache = {half: {k: torch.from_numpy(
                        cache_block(v, rank, world, 2))
                        for k, v in leaves.items()}
                        for half, leaves in full.items()}
                    group.reset_stats()
                    lg, _ = tfm.decode_step(
                        session.params,
                        {"tokens": torch.from_numpy(steps[:, t:t + 1])},
                        cache, t, cfg, xcfg)
                    got.append((_np(lg), group.stats.merge_bytes,
                                group.stats.calls))
                r[f"decode/{name}"] = got
        prompt = torch.from_numpy(job["prompt"])
        for name, plan in plans.items():
            r[f"gen/{name}"] = _np(session.generate(prompt, job["n_new"],
                                                    plan=plan))
        group.reset_stats()
        out = session.generate(prompt, job["n_new"], plan=plans["voltage"],
                               prefill_mode="single_pass")
        r["gen/voltage/single_pass"] = (_np(out), group.stats.cache_bytes,
                                        group.stats.meta_bytes)
    return res


def _flat_layers(a):
    """A JAX cache leaf with the vlm's [groups, layers] axes as one."""
    return a.reshape(-1, *a.shape[-4:])


def xattn_seq(rank, world, job):
    """The audio and vlm families across the group, from the JAX weights:

    * ``job["cross"]``: ``exchange_cross_attention`` on this rank's text
      partition and memory block of each case → (out, payload bytes, meta
      bytes, calls, segment-means K+V calls, PRISM-attention calls);
    * per arch in ``job["archs"]``: ``forward_lm`` under each plan of
      ``job["plans"]`` with the arch's memory input (logits, payload,
      meta, calls, ``last_only`` logits); decode steps under each plan,
      each from the given JAX cache (the self-attention cache's and the
      memory's blocks, the global mask) → (logits, merge bytes, calls);
      greedy ``generate`` under each plan, and under ``voltage`` with the
      memory input of ``"gen_memory"``."""
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.configs import get_config
    from repro_torch.core import exchange as tx
    from repro_torch.kernels import dispatch as kdsp
    from repro_torch.models import transformer as tfm
    from repro_torch.models.bridge import params_from_numpy
    group = get_seq_group("seq")
    res = {"cross": []}
    calls = {"segment_means_kv": [], "prism_attention": []}
    real = {name: getattr(kdsp, name) for name in calls}

    def counted(name):
        def fn(*a, **kw):
            calls[name].append(1)
            return real[name](*a, **kw)
        return fn
    for name in calls:
        setattr(kdsp, name, counted(name))
    try:
        with torch.inference_mode():
            for c in job["cross"]:
                group.reset_stats()
                for n in calls.values():
                    n.clear()
                out = tx.exchange_cross_attention(
                    _part(c["q"], rank, world), _part(c["k"], rank, world),
                    _part(c["v"], rank, world),
                    _part(c["mask"], rank, world), _xcfg(c, world))
                st = group.stats
                res["cross"].append((_np(out), st.payload_bytes,
                                     st.meta_bytes, st.calls,
                                     len(calls["segment_means_kv"]),
                                     len(calls["prism_attention"])))
    finally:
        for name, fn in real.items():
            setattr(kdsp, name, fn)
    for label, a in job["archs"].items():
        cfg = get_config(a["arch"]).reduced(**a["reduced"])
        session = InferenceSession(
            cfg, params_from_numpy(a["params"], cfg), device="cpu")
        plans = {name: ExecutionPlan(seq_axis="seq", seq_shards=world, **kw)
                 for name, kw in job["plans"].items()}
        r = res[label] = {}
        mem = {a["memory_name"]: torch.from_numpy(a["memory"])}
        batch = {"tokens": torch.from_numpy(job["tokens"]), **mem}
        with torch.inference_mode():
            for name, plan in plans.items():
                xcfg = plan.to_exchange_config()
                group.reset_stats()
                logits, _ = tfm.forward_lm(session.params, batch, cfg, xcfg)
                st = group.stats
                moved = (st.payload_bytes, st.meta_bytes, st.calls)
                last = tfm.forward_lm(session.params, batch, cfg, xcfg,
                                      last_only=True)[0]
                r[f"fwd/{name}"] = (_np(logits), *moved, _np(last))
                steps = job["decode_tokens"]
                got = []
                for t, full in enumerate(a["caches"][name]):
                    cache = {"mem_mask": torch.from_numpy(full["mem_mask"])}
                    for half, leaves in full.items():
                        if half != "mem_mask":
                            cache[half] = {k: torch.from_numpy(cache_block(
                                _flat_layers(v), rank, world, 2))
                                for k, v in leaves.items()}
                    group.reset_stats()
                    lg, _ = tfm.decode_step(
                        session.params,
                        {"tokens": torch.from_numpy(steps[:, t:t + 1])},
                        cache, t, cfg, xcfg)
                    got.append((_np(lg), group.stats.merge_bytes,
                                group.stats.calls))
                r[f"decode/{name}"] = got
        prompt = torch.from_numpy(job["prompt"])
        for name, plan in plans.items():
            r[f"gen/{name}"] = _np(session.generate(
                prompt, job["n_new"], plan=plan, batch_extras=mem))
        r["gen/voltage/memory"] = _np(session.generate(
            prompt, job["n_new"], plan=plans["voltage"],
            batch_extras={a["memory_name"]: torch.from_numpy(
                a["gen_memory"])}))
    return res


def _nested(tree, fn):
    """``fn`` on every array leaf of a nested dict (None kept)."""
    if isinstance(tree, dict):
        return {k: _nested(v, fn) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def ssm_seq(rank, world, job):
    """The recurrent families across the group, from the JAX weights; per
    arch in ``job["archs"]``:

    * ``forward_lm`` under each plan of ``job["plans"]`` at each
      ``(N, L)`` of ``job["forwards"]`` → (logits, payload, meta and state
      bytes, calls);
    * decode steps, each from the given JAX cache (the KV half in this
      rank's block, the recurrent states whole) → (logits, merge and state
      bytes, calls);
    * greedy ``generate`` under each plan → (tokens, state bytes)."""
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.bridge import params_from_numpy
    group = get_seq_group("seq")

    def plan_of(kw, L):
        return ExecutionPlan(seq_axis="seq", seq_shards=world,
                             L=L if kw["mode"] == "prism" else 0, **kw)
    res = {}
    for label, a in job["archs"].items():
        cfg = get_config(a["arch"]).reduced(**a["reduced"])
        session = InferenceSession.from_config(
            a["arch"], reduced=a["reduced"], device="cpu",
            params=params_from_numpy(a["params"], cfg))
        r = res[label] = {}
        with torch.inference_mode():
            for name, kw in job["plans"].items():
                for i, (N, L) in enumerate(job["forwards"]):
                    xcfg = plan_of(kw, L).to_exchange_config()
                    group.reset_stats()
                    logits, _ = tfm.forward_lm(
                        session.params,
                        {"tokens": torch.from_numpy(job["tokens"][i])}, cfg,
                        xcfg)
                    st = group.stats
                    r[f"fwd/{name}/{i}"] = (_np(logits), st.payload_bytes,
                                            st.meta_bytes, st.state_bytes,
                                            st.calls)
                xcfg = plan_of(kw, job["L"]).to_exchange_config()
                got = []
                for t, full in enumerate(a["caches"]):
                    cache = {half: _nested(leaves, lambda v, h=half:
                                           torch.from_numpy(
                                               cache_block(v, rank, world, 2)
                                               if h == "kv" else np.array(v)))
                             for half, leaves in full.items()}
                    group.reset_stats()
                    lg, _ = tfm.decode_step(
                        session.params,
                        {"tokens": torch.from_numpy(
                            job["decode_tokens"][:, t:t + 1])},
                        cache, t, cfg, xcfg)
                    st = group.stats
                    got.append((_np(lg), st.merge_bytes, st.state_bytes,
                                st.calls))
                r[f"decode/{name}"] = got
        prompt = torch.from_numpy(job["prompt"])
        for name, kw in job["plans"].items():
            plan = plan_of(kw, job["L"])
            group.reset_stats()
            out = session.generate(prompt, job["n_new"], plan=plan)
            r[f"gen/{name}"] = (_np(out), group.stats.state_bytes)
    return res


def train_seq(rank, world, job):
    """The dense LM's training across the group, from the JAX weights
    (``job["params"]``, numpy), for each mode of ``job["modes"]``: this
    rank's loss share and its gradient, summed over the ranks by the
    staged ``all_reduce`` (every leaf f32, ``tree_leaves`` order), with
    the bytes and calls the step booked (forward + backward, then the
    sum); then ``len(job["steps"])`` train steps from the same weights →
    the params every rank ends on and each step's metrics.  With
    ``job["compress"]``: ``compressed_cross_pod_mean`` of this rank's
    gradient tree and residuals.  ``job["device"]`` (default the CPU)
    runs it on the card; ``job["tparams"]`` (the port's params as CPU
    tensors) stands in for the JAX weights.  With a card the result also
    counts the kernels' launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.prism_attention import prism_attention
    from repro_torch.kernels.segment_means import segment_means
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.train.grad_compress import compressed_cross_pod_mean
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.train_step import _grads_of, build_train_step
    from repro_torch.utils.tree import tree_leaves, tree_map
    group = get_seq_group("seq")
    device = job.get("device", "cpu")
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(job["arch"]).reduced(**job["reduced"])
    params = (tree_map(lambda t: t.to(device), job["tparams"])
              if "tparams" in job else
              params_from_numpy(job["params"], cfg, device=device))

    def tensors(b):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in b.items()}

    out = {}
    for mode in job["modes"]:
        xcfg = ExchangeConfig(ExchangeMode(mode), seq_axis="seq",
                              seq_shards=world, L=job["L"])
        group.reset_stats()
        before = (segment_means.launches, prism_attention.launches)
        loss, _, grads = _grads_of(params, tensors(job["batch"]), cfg, xcfg)
        st = group.stats
        booked = dict(payload=st.payload_bytes, meta=st.meta_bytes,
                      grad=st.grad_bytes, output=st.output_bytes,
                      calls=st.calls,
                      launches=(segment_means.launches - before[0],
                                prism_attention.launches - before[1]))
        summed = group.all_reduce(grads, kind="grad")
        booked["grad_total"] = group.stats.grad_bytes
        booked["calls_total"] = group.stats.calls
        step = build_train_step(cfg, xcfg, OptConfig(lr=1e-3,
                                                     warmup_steps=1))
        p, o, metrics = params, adamw_init(params), []
        for sb in job["steps"]:
            p, o, m = step(p, o, tensors(sb))
            metrics.append({k: float(v) for k, v in m.items()})
        out[mode] = dict(loss=float(loss),
                         grads=[_np(t.cpu()) for t in summed],
                         booked=booked, metrics=metrics,
                         params=[_np(t.cpu()) for t in tree_leaves(p)])
    if "compress" in job:
        c = job["compress"]
        red, res = compressed_cross_pod_mean(
            tree_map(torch.from_numpy, c["grads"][rank]),
            tree_map(torch.from_numpy, c["residuals"][rank]), c["L"], group)
        out["compress"] = (tree_map(_np, red), tree_map(_np, res))
    return out


def _dyadic(rng, shape, dtype=torch.float64, device="cpu"):
    """Small multiples of 1/4: every sum and product below is exact in f32
    as in f64, so a transpose identity holds bit for bit."""
    return torch.from_numpy(rng.randint(-8, 9, shape) / 4.0).to(
        device=device, dtype=dtype)


def grad_collectives(rank, world, job):
    """Each differentiable staged collective as a linear map of this rank's
    input x, with a cotangent y: → per case (⟨op(x), y⟩ on this rank,
    ⟨x, opᵀ(y)⟩ on this rank (the backward of the first), the ``grad``
    bytes and calls the backward booked).  Inputs are drawn from
    ``RandomState(job["seed"] + rank)``; see ``_dyadic``.  ``job["device"]``
    (default the CPU) puts them on the card."""
    group = get_seq_group("seq")
    rng = np.random.RandomState(job["seed"] + rank)
    dev = job.get("device", "cpu")
    P = world
    out = {}

    def draw(shape, dtype=torch.float64):
        return _dyadic(rng, shape, dtype, dev)

    def case(name, xs, fn):
        """``fn(*xs)`` → outputs; y drawn like each; one backward."""
        xs = [x.requires_grad_() if x.is_floating_point() else x
              for x in xs]
        group.reset_stats()
        ys = fn(*xs)
        fwd = group.stats
        cot = [draw(tuple(o.shape), o.dtype) for o in ys]
        dot = sum(float((o.detach().double() * c.double()).sum())
                  for o, c in zip(ys, cot))
        group.reset_stats()
        torch.autograd.backward(list(ys), cot)
        group.flush()
        back = sum(float((x.detach().double() * x.grad.double()).sum())
                   for x in xs if x.is_floating_point()
                   and x.grad is not None)
        out[name] = dict(dot=dot, back=back, grad=group.stats.grad_bytes,
                         calls=group.stats.calls, fwd_calls=fwd.calls,
                         no_grad=[x.grad is None for x in xs
                                  if x.is_floating_point()])

    for sft in range(1, P):
        case(f"shift/{sft}", [draw((2, 3, 5))],
             lambda x, s=sft: [group.shift(x, s)])
    for chunks in (1, 2):
        def ring(x, chunks=chunks):
            got, t = [], group.ring_shift(x, chunks=chunks)
            got.append(t.wait())
            for _ in range(P - 2):
                t = group.ring_forward(t, chunks=chunks)
                got.append(t.wait())
            return [g * (i + 1) for i, g in enumerate(got)]
        case(f"ring/{chunks}", [draw((4, 6))], ring)
    case("packed", [draw((3, 4), torch.float32),
                    torch.from_numpy(rng.randint(-9, 9, (5,))
                                     ).to(device=dev, dtype=torch.int8),
                    draw((2, 2))],
         lambda a, q, c: [t for t in group.all_gather_packed([a, q, c])
                          if t.is_floating_point()])
    like = {"a": torch.empty((2, 3), dtype=torch.float64, device="meta"),
            "b": torch.empty((4,), dtype=torch.float32, device="meta")}

    def chain(xa, xb, xo):
        def fn(got):
            if got is None:
                return xo * 1, {"a": xa * 1, "b": xb * 1}
            return (xo + got["a"].sum() + 3 * got["b"].sum(),
                    {"a": xa + got["a"], "b": xb + 2 * got["b"]})
        return [group.pass_on(fn, like, dev, anchor=xo)]
    case("pass_on", [draw((2, 3)),
                     draw((4,), torch.float32),
                     draw((5,))], chain)
    for src in (0, P - 1):
        case(f"broadcast/{src}", [draw((3, 7), torch.float32)],
             lambda x, s=src: [group.broadcast(x, src=s)])
    return out


def train_families(rank, world, job):
    """Partitioned training of each case of ``job["cases"]`` (arch, mode
    and exchange options: L, codec, codec_param, overlap_chunks) from the
    JAX weights of its arch (``job["params"][arch]``, numpy): this rank's
    loss share and its gradient, summed over the ranks by the staged
    ``all_reduce`` (every leaf f32, ``tree_leaves`` order), with what the
    forward + backward booked (bytes by kind, calls, halo and state
    calls); then ``len(job["steps"])`` train steps from the same weights →
    the params every rank ends on and each step's metrics."""
    from repro_torch.configs import get_config
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.train_step import _grads_of, build_train_step
    from repro_torch.utils.tree import tree_leaves
    group = get_seq_group("seq")

    def tensors(b):
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in b.items()}

    out = {}
    for label, c in job["cases"].items():
        cfg = get_config(c["arch"]).reduced(**job["reduced"])
        params = params_from_numpy(job["params"][c["arch"]], cfg)
        xcfg = _xcfg(c, world)
        group.reset_stats()
        loss, parts, grads = _grads_of(params, tensors(job["batch"][label]),
                                       cfg, xcfg)
        st = group.stats
        booked = dict(payload=st.payload_bytes, meta=st.meta_bytes,
                      state=st.state_bytes, grad=st.grad_bytes,
                      output=st.output_bytes, calls=st.calls,
                      halo_calls=st.halo_calls, state_calls=st.state_calls)
        summed = group.all_reduce(grads, kind="grad")
        step = build_train_step(cfg, xcfg, OptConfig(lr=1e-3,
                                                     warmup_steps=1))
        p, o, metrics = params, adamw_init(params), []
        for sb in job["steps"][label]:
            p, o, m = step(p, o, tensors(sb))
            metrics.append({k: float(v) for k, v in m.items()})
        out[label] = dict(loss=float(loss), aux=float(parts["aux"]),
                          grads=[_np(t) for t in summed], booked=booked,
                          metrics=metrics,
                          params=[_np(t) for t in tree_leaves(p)])
    for label, c in job.get("broadcast", {}).items():
        out[label] = _broadcast_grads(group, world, c)
    return out


def _broadcast_grads(group, world, c):
    """The gradient of a loss of logits that reach every rank by the seq
    group's ``broadcast``: the ViT's class logits (cross-entropy against
    ``c["labels"]``) or an LM's ``last_only`` logits (their logsumexp),
    each rank taking 1/P of it → (loss summed over the ranks, the gradient
    summed by ``all_reduce``, the bytes booked)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.models.vit import forward_vit
    from repro_torch.utils.tree import tree_leaves, tree_unflatten_like
    cfg = get_config(c["arch"]).reduced(dtype="float32")
    params = params_from_numpy(c["params"], cfg)
    xcfg = _xcfg(c, world)
    leaves = tree_leaves(params)
    live = [t.detach().requires_grad_() for t in leaves]
    tree = tree_unflatten_like(params, live)
    group.reset_stats()
    if cfg.family == "vit":
        logits = forward_vit(tree, torch.from_numpy(c["images"]), cfg, xcfg)
        labels = torch.from_numpy(c["labels"]).long()
        loss = torch.nn.functional.cross_entropy(logits, labels)
    else:
        logits, _ = tfm.forward_lm(tree, {"tokens": torch.from_numpy(
            c["tokens"])}, cfg, xcfg, last_only=True)
        loss = torch.logsumexp(logits, dim=-1).mean()
    share = loss / world
    grads = torch.autograd.grad(share, live, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    st = group.stats
    booked = dict(output=st.output_bytes, grad=st.grad_bytes,
                  calls=st.calls)
    summed = group.all_reduce(grads, kind="grad")
    total = group.all_reduce([share.detach()[None]], kind="meta")[0]
    return dict(loss=float(total[0]), grads=[_np(t) for t in summed],
                logits=_np(logits), booked=booked)


def remat_case(group, c, params_np, batch):
    """One training case (``c``: arch, reduced config overrides, mode and
    exchange options) on this rank (``group`` None: one process, no
    exchange), from the JAX weights ``params_np``: this rank's loss share
    and gradient, with and without rematerialisation → for each (``"on"``,
    ``"off"``): the loss, the gradient leaves, what the group booked
    (bytes by kind, calls, halo and state calls), the point-to-point tags
    taken, and the bytes of the tensors autograd saved outside the
    rematerialised regions (the parameters not counted)."""
    from repro_torch.configs import get_config
    from repro_torch.models import remat
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.train.train_step import _grads_of
    from repro_torch.utils.tree import tree_leaves
    cfg = get_config(c["arch"]).reduced(**c["reduced"])
    params = params_from_numpy(params_np, cfg)
    xcfg = (ExchangeConfig() if group is None else _xcfg(c, group.world_size))
    owned = {t.untyped_storage().data_ptr() for t in tree_leaves(params)}
    tokens = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in batch.items()}
    out = {}
    for name in ("on", "off"):
        saved = {}

        def pack(t):
            st = t.untyped_storage()
            if st.data_ptr() not in owned:
                saved[st.data_ptr()] = st.nbytes()
            return t

        ctx = (remat.disabled() if name == "off"
               else contextlib.nullcontext())
        if group is not None:
            group.reset_stats()
            tag0 = group._tag
        with ctx, torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _, grads = _grads_of(params, tokens, cfg, xcfg)
        res = dict(loss=_np(loss), grads=[_np(g) for g in grads],
                   saved=sum(saved.values()))
        if group is not None:
            group.flush()
            st = group.stats
            res.update(tags=group._tag - tag0, booked=dict(
                payload=st.payload_bytes, meta=st.meta_bytes,
                state=st.state_bytes, grad=st.grad_bytes,
                output=st.output_bytes, calls=st.calls,
                halo_calls=st.halo_calls, state_calls=st.state_calls))
        out[name] = res
    return out


def remat_grads(rank, world, job):
    """``remat_case`` for each case of ``job["cases"]`` on this rank of
    the group (the JAX weights of each arch in ``job["params"]``, the
    batch of each case in ``job["batch"]``)."""
    group = get_seq_group("seq")
    return {label: remat_case(group, c, job["params"][label],
                              job["batch"][label])
            for label, c in job["cases"].items()}


def _booked(groups):
    """Bytes received by kind on each mesh axis's group."""
    return {g.axis: {f[:-6]: v for f, v in vars(g.stats).items()
                     if f.endswith("_bytes")} for g in groups}


def mesh_train(rank, world, job):
    """One rank of a ``("data", "model")`` mesh (``spawn_mesh``), from the
    JAX weights (``job["params"]``), for each mode of ``job["modes"]``:
    the global batch's loss and its gradient summed over the mesh, each of
    this rank's optimizer blocks gathered whole (f32, JAX layout; rank 0
    returns them, every rank their digest), with the bytes booked on each
    axis's group; then one train step (AdamW with clipping) → its metrics,
    the bytes it booked, the params gathered whole (rank 0) and the digests
    of this rank's shards and of the whole params.  ``job["save"]``: the
    directory to checkpoint ``job["save_mode"]``'s stepped state into (at
    step 1).  ``job["restore"]``: restore the newest checkpoint there into
    this mesh → the blocks restored, their placements and whole params.
    ``job["forward"]``: a ``prism`` forward and a decode step over the
    mesh, each row its slice of the batch → the row's logits.
    ``job["accum"]``: mode → microbatches of a second mesh gradient (its
    loss, gradient, bytes and calls under ``"<mode>/accum<n>"``).
    ``job["others"]``: label → another arch's mesh gradient (``arch``,
    ``mode``, ``params``, ``batch``: its loss, aux loss, gradient, bytes
    and calls under the label).  Each
    gradient also gives its calls by axis and kind and the stack dims of
    each leaf."""
    import hashlib

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.kernels.prism_attention import prism_attention
    from repro_torch.kernels.segment_means import segment_means
    from repro_torch.launch.mesh import get_abstract_mesh
    from repro_torch.models import registry
    from repro_torch.models import transformer as tfm
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.sharding.placement import Placement
    from repro_torch.sharding.specs import make_plan
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (build_train_step,
                                              mesh_gradients)
    from repro_torch.utils.tree import tree_map
    device = job.get("device", "cpu")
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = get_abstract_mesh()
    groups = [get_seq_group(a) for a in mesh.axis_names]
    cfg = get_config(job["arch"]).reduced(**job["reduced"])
    params = (tree_map(lambda t: t.to(device), job["tparams"])
              if "tparams" in job else
              params_from_numpy(job["params"], cfg, device=device))

    def tensors(b):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in b.items()}

    def digest(ts):
        h = hashlib.sha1()
        for t in ts:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()

    def whole_np(d):
        return {k: v.detach().float().cpu().numpy() for k, v in d.items()}

    out = {"coords": mesh.coords(rank)}
    for mode, n in job.get("accum", {}).items():
        plan = make_plan(mesh, cfg, ExchangeMode(mode), L=job["L"],
                         train=True)
        place = Placement(plan, cfg, registry.abstract_params(cfg))
        blocks, _ = place.init_state(params)
        for g in groups:
            g.reset_stats()
        with logged_calls() as log:
            loss, _, g = mesh_gradients(blocks, tensors(job["batch"]), cfg,
                                        place, grad_accum=n)
        res = dict(loss=float(loss), booked_grads=_booked(groups),
                   calls=calls_by_kind(log))
        grads = place.whole(g, place.opt_spec)
        out[f"{mode}/accum{n}"] = dict(
            res, grads=whole_np(grads) if rank == 0 else None)
    for mode in job.get("modes", ()):
        plan = make_plan(mesh, cfg, ExchangeMode(mode), L=job["L"],
                         train=True)
        place = Placement(plan, cfg, registry.abstract_params(cfg))
        blocks, opt = place.init_state(params)
        for g in groups:
            g.reset_stats()
        before = (segment_means.launches, prism_attention.launches)
        with logged_calls() as log:
            loss, _, g = mesh_gradients(blocks, tensors(job["batch"]), cfg,
                                        place)
        booked_grads = _booked(groups)
        launches = (segment_means.launches - before[0],
                    prism_attention.launches - before[1])
        grads = place.whole(g, place.opt_spec)
        for gr in groups:
            gr.reset_stats()
        step = build_train_step(cfg, plan.xcfg,
                                OptConfig(lr=1e-3, warmup_steps=1),
                                placement=place)
        new, opt2, m = step(blocks, opt, tensors(job["batch"]))
        booked_step = _booked(groups)
        whole = place.whole(new, place.spec)
        res = dict(loss=float(loss), grad_digest=digest(grads.values()),
                   launches=launches, calls=calls_by_kind(log),
                   leads={k: e.lead for k, e in place.index_of.items()},
                   whole_shapes={k: e.shape
                                 for k, e in place.index_of.items()},
                   booked_grads=booked_grads, booked_step=booked_step,
                   metrics={k: float(v) for k, v in m.items()},
                   shard_digest=digest(new[k] for k in place.keys),
                   param_digest=digest(whole.values()),
                   block_shapes={k: tuple(new[k].shape) for k in place.keys},
                   opt_shapes={k: tuple(opt2.m[k].shape)
                               for k in place.keys})
        moments = [place.whole(t, place.opt_spec) for t in (opt2.m, opt2.v)]
        if rank == 0:                   # (every rank gathers: collectives)
            res.update(grads=whole_np(grads), params=whole_np(whole),
                       m=whole_np(moments[0]), v=whole_np(moments[1]))
        if job.get("save") and mode == job["save_mode"]:
            mgr = CheckpointManager(job["save"]) if rank == 0 else None
            place.save(mgr, new, opt2, 1)
            if mgr is not None:
                mgr.wait()
        out[mode] = res
    for label, m in job.get("others", {}).items():
        mcfg = get_config(m["arch"]).reduced(**job["reduced"])
        plan = make_plan(mesh, mcfg, ExchangeMode(m["mode"]), L=job["L"],
                         train=True)
        place = Placement(plan, mcfg, registry.abstract_params(mcfg))
        blocks, _ = place.init_state(
            params_from_numpy(m["params"], mcfg, device=device))
        for g in groups:
            g.reset_stats()
        with logged_calls() as log:
            loss, parts, g = mesh_gradients(blocks, tensors(m["batch"]), mcfg,
                                            place)
        booked = _booked(groups)
        grads = place.whole(g, place.opt_spec)
        out[label] = dict(
            loss=float(loss), aux=float(parts["aux"]),
            booked_grads=booked, calls=calls_by_kind(log),
            grad_digest=digest(grads.values()),
            leads={k: e.lead for k, e in place.index_of.items()},
            whole_shapes={k: e.shape for k, e in place.index_of.items()},
            grads=whole_np(grads) if rank == 0 else None)
    if job.get("restore"):
        plan = make_plan(mesh, cfg, ExchangeMode(job["save_mode"]),
                         L=job["L"], train=True)
        place = Placement(plan, cfg, registry.abstract_params(cfg))
        template, places = place.state_template()
        blocks, opt = CheckpointManager(job["restore"]).restore(
            template, device=device, placements=places)
        out["restored"] = dict(
            params={k: v.float().numpy() for k, v in blocks.items()},
            m={k: v.numpy() for k, v in opt.m.items()},
            step=int(opt.step),
            index={k: place.index(k, place.spec[k]) for k in place.keys},
            opt_index={k: place.index(k, place.opt_spec[k])
                       for k in place.keys},
            whole=whole_np(place.whole(blocks, place.spec)))
    if job.get("forward"):
        plan = make_plan(mesh, cfg, ExchangeMode.PRISM, L=job["L"])
        i, n = out["coords"]["data"], mesh.shape["data"]
        rows = {k: v[i * v.shape[0] // n:(i + 1) * v.shape[0] // n]
                for k, v in tensors(job["forward"]).items()}
        with torch.no_grad():
            logits, _ = registry.forward_fn(cfg)(params, rows, plan.xcfg)
            B, S = rows["tokens"].shape
            cache = tfm.init_decode_cache(cfg, B, S, device=device,
                                          xcfg=plan.xcfg)
            dec, _ = tfm.decode_step(params, {"tokens": rows["tokens"][:, :1]},
                                     cache, 0, cfg, plan.xcfg)
        out["forward"] = dict(logits=_np(logits.cpu()),
                              decode=_np(dec.float().cpu()))
    return out


def _tp_collectives(g, seed):
    """The row's TP collectives on dyadic f32 inputs (sums exact in any
    order): each one's output and its input's gradient from a cotangent,
    with the ``tp`` bytes booked by each."""
    rng = np.random.RandomState(seed + g.rank)
    t = _dyadic(rng, (3, 4, 5), torch.float32)
    ct = _dyadic(rng, (3, 4, 5), torch.float32)
    wide = _dyadic(rng, (3, 4, 5 * g.world_size), torch.float32)
    out = dict(t=_np(t), ct=_np(ct), wide=_np(wide))
    for name in ("copy_to", "reduce_from", "gather_from", "gather_to"):
        g.reset_stats()
        x = t.clone().requires_grad_()
        y = getattr(g, name)(x)
        y.backward(wide if name.startswith("gather") else ct)
        out[name] = dict(y=_np(y.detach()), grad=_np(x.grad),
                         tp=g.stats.tp_bytes, calls=g.stats.calls)
    out["gather_blocks"] = _gather_blocks_case(g, rng)
    return out


def _gather_blocks_case(g, rng):
    """``SeqGroup.gather_blocks`` on three pieces (f32 [3, 4] joined along
    dim 0 and summed, bf16 [2, 5] along dim 1 not summed, f32 [4]
    stacked and summed) with 48-byte buckets (the [3, 4] piece alone,
    then the other two): the joined outputs, each input's gradient from a
    cotangent of the joined shape, and the bytes and calls booked each
    way."""
    from repro_torch.core import seq_group as sg
    P = g.world_size
    xs = [_dyadic(rng, (3, 4), torch.float32),
          _dyadic(rng, (2, 5), torch.bfloat16),
          _dyadic(rng, (4,), torch.float32)]
    cts = [_dyadic(rng, (3 * P, 4), torch.float32),
           _dyadic(rng, (2, 5 * P), torch.bfloat16),
           _dyadic(rng, (P, 4), torch.float32)]
    leaves = [x.clone().requires_grad_() for x in xs]
    bucket, sg.BUCKET_BYTES = sg.BUCKET_BYTES, 48
    try:
        g.reset_stats()
        ys = g.gather_blocks(leaves, [0, 1, None], [True, False, True])
        fwd = dict(param=g.stats.param_bytes, calls=g.stats.calls)
        g.reset_stats()
        torch.autograd.backward(ys, cts)
    finally:
        sg.BUCKET_BYTES = bucket
    return dict(x=[_np(x.float()) for x in xs],
                ct=[_np(c.float()) for c in cts],
                y=[_np(y.detach().float()) for y in ys],
                grad=[_np(x.grad.float()) for x in leaves], fwd=fwd,
                bwd=dict(grad=g.stats.grad_bytes, calls=g.stats.calls))


def _tp_params(c, cfg, device="cpu"):
    """The case's port params: ``c["tparams"]`` (a port tree) or the JAX
    weights ``c["params"]`` through the bridge, on ``device``."""
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.utils.tree import tree_map
    if "tparams" in c:
        return tree_map(lambda t: t.to(device), c["tparams"])
    return params_from_numpy(c["params"], cfg, device=device)


def _tp_train_case(c, mesh, groups, rank):
    """One family's ``local`` train step on this mesh with tensor
    parallelism over ``model``: the loss, the gradient summed over the
    mesh and gathered whole (rank 0), the bytes booked by kind on each
    axis, the shapes of this rank's blocks between steps and of the tree
    the model runs on; with ``c["step"]`` one AdamW step, with
    ``c["save"]`` a checkpoint of it, with ``c["no_remat"]`` the gradient
    again without rematerialisation."""
    import hashlib

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models import registry, remat
    from repro_torch.sharding.placement import Placement
    from repro_torch.sharding.specs import make_plan
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import build_train_step, mesh_gradients

    def digest(ts):
        h = hashlib.sha1()
        for t in ts:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()

    def whole_np(d):
        return {k: v.detach().float().cpu().numpy() for k, v in d.items()}

    cfg = get_config(c["arch"]).reduced(**c["reduced"])
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in c["batch"].items()}
    plan = make_plan(mesh, cfg, ExchangeMode.LOCAL, train=True)
    place = Placement(plan, cfg, registry.abstract_params(cfg))
    blocks, opt = place.init_state(_tp_params(c, cfg))
    raw = {}
    if c.get("raw_leaves"):        # those leaves' gradients, unsummed
        reduce = place.reduce_gradients

        def spy(grads, entry=None):
            raw.update({k: g.detach().float().cpu().numpy()
                        for k, g in grads.items()
                        if k.rsplit("/", 1)[1] in c["raw_leaves"]})
            return reduce(grads, entry)
        place.reduce_gradients = spy
    for g in groups:
        g.reset_stats()
    with logged_calls() as log:
        loss, parts, grad = mesh_gradients(blocks, batch, cfg, place,
                                           grad_accum=c.get("accum", 1))
    res = dict(loss=float(loss), aux=float(parts["aux"]),
               booked=_booked(groups), tp_keys=sorted(place.tp_dim),
               sliced=sorted(place.sliced), moved=sorted(place.moved),
               raw=raw, calls=calls_by_kind(log),
               leads={k: e.lead for k, e in place.index_of.items()},
               whole_shapes={k: e.shape for k, e in place.index_of.items()},
               block_shapes={k: tuple(blocks[k].shape) for k in place.keys})
    grads = place.whole(grad, place.opt_spec)
    res["grad_digest"] = digest(grads.values())
    if rank == 0:
        res["grads"] = whole_np(grads)
    if c.get("no_remat"):
        with remat.disabled():
            for g in groups:
                g.reset_stats()
            _, _, g2 = mesh_gradients(blocks, batch, cfg, place)
            res["no_remat"] = dict(
                booked=_booked(groups),
                same=digest(place.whole(g2, place.opt_spec).values())
                == res["grad_digest"])
    view = place.layer_view(blocks)         # every layer gathered at once
    res["held_shapes"] = {k: tuple(v.shape) for k, v in place.stack(
        view(view.tree)).items()}
    if c.get("step"):
        for g in groups:
            g.reset_stats()
        step = build_train_step(cfg, plan.xcfg,
                                OptConfig(lr=1e-3, warmup_steps=1),
                                grad_accum=c.get("accum", 1),
                                placement=place)
        new, opt2, m = step(blocks, opt, batch)
        whole = place.whole(new, place.spec)
        res.update(metrics={k: float(v) for k, v in m.items()},
                   booked_step=_booked(groups),
                   step_blocks={k: (str(place.index(k, place.spec[k])),
                                    digest([new[k]])) for k in place.keys},
                   param_digest=digest(whole.values()))
        moments = [place.whole(t, place.opt_spec) for t in (opt2.m, opt2.v)]
        if rank == 0:
            res.update(params=whole_np(whole), m=whole_np(moments[0]),
                       v=whole_np(moments[1]))
        if c.get("save"):
            mgr = CheckpointManager(c["save"]) if rank == 0 else None
            place.save(mgr, new, opt2, 1)
            if mgr is not None:
                mgr.wait()
    return res


def _tp_serve_case(c):
    """The serving step builders on this mesh under ``c["mode"]``'s decode
    plan: the prefill step's last logits of this rank's rows, then
    ``c["steps"]`` greedy decode steps from an empty cache (the prompt
    teacher-forced first), the tokens gathered over the column each step
    → this rank's logits a step, the global tokens and the flash-decode
    launches (on ``c["device"]``, default the CPU), and whether the held
    params widened over the row (``Placement.widened``) are the whole
    ones, and the shapes of the rank's cache.  ``c["fsdp"]``: the plan
    with ZeRO-3 params (the rank's blocks, ``Placement.param_blocks``,
    each layer gathered as the loop reaches it; widened: a view of the
    blocks gathered whole) → also the largest gathered bytes alive at
    once."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.launch.mesh import get_abstract_mesh
    from repro_torch.serving import engine
    from repro_torch.sharding.placement import Placement
    from repro_torch.sharding.specs import make_plan
    from repro_torch.models import registry
    from repro_torch.utils.tree import tree_leaves
    cfg = get_config(c["arch"]).reduced(**c["reduced"])
    plan = make_plan(get_abstract_mesh(), cfg, ExchangeMode(c["mode"]),
                     L=c.get("L", 0), decode=True)
    if c.get("fsdp"):
        plan = dataclasses.replace(plan, fsdp=True)
    place = Placement(plan, cfg, registry.abstract_params(cfg))
    device = c.get("device", "cpu")
    whole = _tp_params(c, cfg, device)
    params = (place.param_blocks(whole) if plan.fsdp
              else place.held_params(whole))
    views = []
    col = get_seq_group("data")
    prompt = torch.from_numpy(c["prompt"]).to(device)
    B, T0 = prompt.shape
    S = T0 + c["steps"]
    prefill = engine.build_prefill_step(cfg, plan.xcfg, plan)
    step = engine.build_decode_step(cfg, plan.xcfg, plan)
    with torch.no_grad(), _kept_views(views):
        first, _ = prefill(params, {"tokens": prompt},
                           engine.init_cache(cfg, plan, B, S, device))
        cache = engine.init_cache(cfg, plan, B, S, device)
        tok, logits, tokens = prompt[:, :1], [], []
        before = flash_decode.launches
        for i in range(S - 1):
            lg, cache = step(params, {"tokens": tok}, cache, i)
            logits.append(_np(lg.float().cpu()))
            mine = lg[:, -1].argmax(-1).cpu()
            got = torch.cat([torch.as_tensor(t) for t in
                             col.all_gather_object(mine.numpy())])
            tok = (prompt[:, i + 1:i + 2] if i + 1 < T0 else
                   got[:, None].to(device=device, dtype=prompt.dtype))
            if i + 1 >= T0:
                tokens.append(got.numpy())
    if plan.fsdp:
        view = place.layer_view(params, whole=True)
        widened = view(view.tree)
        held = {k: tuple(v.shape) for k, v in params.items()}
    else:
        widened = place.widened(params)
        held = {k: tuple(v.shape) for k, v in place.stack(params).items()}
    return dict(prefill=_np(first.float().cpu()), logits=np.stack(logits),
                tokens=np.stack(tokens, 1),
                launches=flash_decode.launches - before,
                held=held, views=len(views),
                whole_shapes={k: e.shape for k, e in place.index_of.items()},
                leads={k: e.lead for k, e in place.index_of.items()},
                tp_keys=sorted(place.tp_dim),
                kv_heads=_cache_heads(cache),
                cache_shapes={half: {k: tuple(t.shape) for k, t in v.items()}
                              for half, v in cache.items()
                              if isinstance(v, dict)},
                widened=all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(widened), tree_leaves(whole))))


@contextlib.contextmanager
def _kept_views(views):
    """Every ``Placement.layer_view`` made inside the block, appended to
    ``views`` (one a step)."""
    from repro_torch.sharding.placement import Placement
    make = Placement.layer_view

    def spy(self, *args, **kw):
        views.append(make(self, *args, **kw))
        return views[-1]
    Placement.layer_view = spy
    try:
        yield views
    finally:
        Placement.layer_view = make


def _cache_heads(cache):
    """The KV heads of a dense decode cache's first half (None: a latent
    cache)."""
    half = next(v for v in cache.values() if isinstance(v, dict))
    return half["k"].shape[-2] if "k" in half else None


def tp_mesh(rank, world, job):
    """One rank of a ``("data", "model")`` mesh under tensor parallelism
    over ``model`` (``spawn_mesh``), from the JAX weights: the TP
    collectives (``job["collectives"]``: a seed), each case of
    ``job["cases"]`` (``_tp_train_case``), each of ``job["serve"]``
    (``_tp_serve_case``), and ``job["restore"]``: the newest checkpoint
    there restored into this mesh under ``job["restore_case"]``'s
    ``local`` plan → the blocks, their placements and whole params."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import get_abstract_mesh
    from repro_torch.models import registry
    from repro_torch.sharding.placement import Placement
    from repro_torch.sharding.specs import make_plan
    mesh = get_abstract_mesh()
    groups = [get_seq_group(a) for a in mesh.axis_names]
    out = {"coords": mesh.coords(rank)}
    if "collectives" in job:
        out["collectives"] = _tp_collectives(get_seq_group("model"),
                                             job["collectives"])
    for label, c in job.get("cases", {}).items():
        out[label] = _tp_train_case(c, mesh, groups, rank)
    out["serve"] = {label: _tp_serve_case(c)
                    for label, c in job.get("serve", {}).items()}
    if job.get("restore"):
        c = job["restore_case"]
        cfg = get_config(c["arch"]).reduced(**c["reduced"])
        place = Placement(make_plan(mesh, cfg, ExchangeMode.LOCAL,
                                    train=True),
                          cfg, registry.abstract_params(cfg))
        template, places = place.state_template()
        blocks, opt = CheckpointManager(job["restore"]).restore(
            template, device="cpu", placements=places)
        out["restored"] = dict(
            params={k: v.float().numpy() for k, v in blocks.items()},
            m={k: v.numpy() for k, v in opt.m.items()}, step=int(opt.step),
            index={k: place.index(k, place.spec[k]) for k in place.keys},
            opt_index={k: place.index(k, place.opt_spec[k])
                       for k in place.keys},
            tp_keys=sorted(place.tp_dim))
    return out


# --- the dry run's abstract collectives against the real ones --------------

@contextlib.contextmanager
def logged_calls():
    """Every call a seq group books (real or abstract), in order: (axis,
    kind, bytes received) appended to the list yielded."""
    from repro_torch.core.seq_group import AbstractSeqGroup, SeqGroup
    log = []
    saved = {cls: cls._end for cls in (SeqGroup, AbstractSeqGroup)}

    def wrap(orig):
        def _end(self, t0, kind, received):
            log.append((self.axis, kind, int(received)))
            return orig(self, t0, kind, received)
        return _end
    for cls, orig in saved.items():
        cls._end = wrap(orig)
    try:
        yield log
    finally:
        for cls, orig in saved.items():
            cls._end = orig


def calls_by_kind(log):
    """``logged_calls``' log → {axis: {kind: calls}}."""
    out = {}
    for axis, kind, _ in log:
        out.setdefault(axis, {}).setdefault(kind, 0)
        out[axis][kind] += 1
    return out


def stats_of(groups):
    """Each group's ``GatherStats`` by axis, every field but seconds."""
    return {g.axis: {f: v for f, v in vars(g.stats).items()
                     if f != "seconds"} for g in groups}


def dry_cfg(c):
    from repro_torch.configs import get_config
    return get_config(c["arch"]).reduced(dtype="float32",
                                         **c.get("over", {}))


def dryrun_mesh(rank, world, job):
    """One rank of a mesh (``spawn_mesh``), each case of ``job["cases"]``
    from seed-0 weights and a seeded global batch: a mesh train step
    (``kind`` "train": ``build_train_step`` with the plan's placement) or
    one ``build_decode_step`` step with the plan at position N − 1
    (``kind`` "decode"), on ``job["device"]`` (default the CPU) → the
    ``GatherStats`` of each of the rank's groups and every call booked, in
    order."""
    from repro_torch.launch.mesh import get_abstract_mesh, mesh_groups
    from repro_torch.models import registry
    from repro_torch.serving import engine
    from repro_torch.sharding.placement import Placement
    from repro_torch.sharding.specs import make_plan
    from repro_torch.train.train_step import build_train_step
    mesh = get_abstract_mesh()
    groups = mesh_groups()
    device = job.get("device", "cpu")
    out = {"coords": mesh.coords(rank)}
    for label, c in job["cases"].items():
        cfg = dry_cfg(c)
        kind, B, N = c["kind"], c["B"], c["N"]
        plan = make_plan(mesh, cfg, ExchangeMode(c["mode"]), L=c["L"],
                         train=kind == "train", decode=kind == "decode")
        params = registry.init_params(cfg, seed=0, device=device)
        place = Placement(plan, cfg, registry.abstract_params(cfg))
        rng = np.random.RandomState(c.get("seed", 1))
        tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, N))
                                  .astype(np.int32)).to(device)
        for g in groups:
            g.reset_stats()
        if kind == "train":
            blocks, opt = place.init_state(params)
            step = build_train_step(cfg, plan.xcfg, placement=place)
            batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
            with logged_calls() as log:
                step(blocks, opt, batch)
        else:
            held = place.held_params(params)
            cache = engine.init_cache(cfg, plan, B, N, device=device)
            step = engine.build_decode_step(cfg, plan.xcfg, plan)
            with logged_calls() as log, torch.no_grad():
                step(held, {"tokens": tokens[:, :1]}, cache, N - 1)
        out[label] = dict(stats=stats_of(groups), log=log)
    return out


def seq_case(c, params, batch):
    """``c``'s forward (``forward_lm`` without grad) or its loss's
    gradient (``c["grad"]``) under ``c["mode"]`` over the seq group
    ``"seq"`` of 2 ranks, on the tensors given."""
    from repro_torch.models import transformer as tfm
    from repro_torch.train.train_step import _grads_of
    cfg = dry_cfg(c)
    xcfg = ExchangeConfig(ExchangeMode(c["mode"]), "seq", 2, L=c["L"])
    if c.get("grad"):
        _grads_of(params, batch, cfg, xcfg)
    else:
        with torch.no_grad():
            tfm.forward_lm(params, batch, cfg, xcfg)


def dryrun_seq(rank, world, job):
    """One rank of a seq group of 2 (``spawn``): each case of
    ``job["cases"]`` (``seq_case``) from seed-0 weights and a seeded
    batch → the group's ``GatherStats`` and every call booked, in
    order."""
    from repro_torch.models import registry
    group = get_seq_group("seq")
    out = {}
    for label, c in job["cases"].items():
        cfg = dry_cfg(c)
        params = registry.init_params(cfg, seed=0, device="cpu")
        rng = np.random.RandomState(1)
        tokens = torch.from_numpy(rng.randint(
            0, cfg.vocab_size, (c["B"], c["N"])).astype(np.int32))
        group.reset_stats()
        with logged_calls() as log:
            seq_case(c, params, {"tokens": tokens,
                                 "labels": tokens.roll(-1, 1)})
        out[label] = dict(stats=stats_of([group]), log=log)
    return out
