#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py

Phases, one line each (more for the kernel table):

1. device    — the card's name, the device count and ``nvidia-smi``'s name
               and power limit; fails without a CUDA card.
2. build     — builds every kernel of the main paths from the sources in
               the checkout (``nvcc``, one process per source, started
               together), before any rank is spawned.
3. kernels   — calls each kernel's wrapper on tensors on the card and
               holds it against its plain PyTorch version on the same
               inputs (f32 inputs: relative max error ≤ 1e-5; bf16:
               ≤ 1e-3), at the main paths' shapes and a few harder ones,
               and times kernel, plain version and a one-call PyTorch
               yardstick with CUDA events (warm-up, then the median of many
               launches on inputs cold in L2).
   The paged flash-decode kernel is held likewise at the paged pool's
               shape and harder ones (page sizes 8 and 5, dh 128, f32,
               softcap, shuffled and shared pages, trash entries, a fully
               masked row), and timed beside a two-call yardstick and the
               dense kernel on the gathered cache.
4. reference — small f32 models on the card against the same weights on
               the CPU: a llama decoded 12 steps; the same llama served by
               ``ServingRuntime`` in dense and paged mode with full and
               partial prefix hits; and a ViT whose Voltage and PRISM
               forwards run across 2 ranks on the card, held against one
               CPU process that composes the PRISM exchange partition by
               partition from the plain functions.
5. session   — llama3.2-1b at full width: ``InferenceSession`` profile →
               decide → dispatch → greedy generate under ``local`` and
               ``prism_sim``, flash-decode launch counts read around each
               generate, and the kernel time of one ``local`` generate from
               ``torch.profiler``.
6. serve     — the same model served by ``ServingRuntime``: 24 requests
               (16 extending a shared system prompt) through the paged pool
               and then the dense slot pool, with paged and dense
               flash-decode launch counts, prefix hits and a clean
               allocator asserted, and throughput, latency, time to first
               token, step time, idle share and agreement with B=1
               ``generate`` printed.
7. vit       — ViT-B/16 at full width across 2 ranks that share the one
               card and exchange over gloo, staged through host memory:
               ``local``, ``voltage`` and ``prism(L=20)`` forwards of 8
               synthetic images, with segment-means and PRISM-attention
               launch counts and gathered bytes per forward asserted, and
               the forward wall time with its staged-collective part.

The line before the last is a JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.  Any failure (a rank
that fails or hangs included) exits non-zero and prints no result.
"""
from __future__ import annotations

import concurrent.futures
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM, published
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, published
N_HEADS, N_KV, ARCH = 32, 8, "llama3.2-1b"
PROMPT_B, PROMPT_T, N_NEW = 4, 32, 16
VIT, VIT_B, VIT_P, VIT_L, VIT_CR = "vit-base-16", 8, 2, 20, 4.95
VIT_TOKENS = 197                          # 196 patches + CLS
SMALL_VIT = dict(dtype="float32", n_layers=2, d_model=256, n_heads=4,
                 n_kv_heads=4, head_dim=64, d_ff=512, vocab_size=10)
SMALL_L = 5
RANK_TIMEOUT_S = 600


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


L2_BYTES = 50e6                           # H100 L2 cache


def time_ms(fn, arg_sets, min_calls: int = 20, reps: int = 30) -> float:
    """Median device ms of one ``fn(*args)``.  The calls cycle through
    ``arg_sets``, which together hold about twice the L2, so each call finds
    its inputs cold, as a decode step finds each layer's cache after the
    other layers' weights have streamed through L2.  At least ``min_calls``
    calls are captured in a CUDA graph (so host launch cost is excluded)
    and replayed ``reps`` times between CUDA events, after a warm-up."""
    import torch
    n = len(arg_sets) * -(-min_calls // len(arg_sets))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                       # warm-up
        for args in arg_sets[:3]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 3: flash-decode against its plain version
# ---------------------------------------------------------------------------

def decode_case(B, S, dh, dtype, *, seed, window=None, softcap=None,
                masked_row=False):
    import torch
    from repro_torch.kernels.flash_decode import validity_bias
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)
    q, k, v = randn(B, N_HEADS, dh), randn(B, S, N_KV, dh), randn(B, S, N_KV, dh)
    clen = torch.randint(1, S + 1, (B,), generator=g, device="cuda")
    if masked_row:
        clen[0] = 0
    bias = validity_bias(B, S, clen, window=window, device="cuda")
    return dict(q=q, k=k, v=v, bias=bias, softcap=softcap)


def check_case(case) -> dict:
    """Kernel vs plain version on one case → errors; raises past tolerance."""
    import torch
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
    args = (case["q"], case["k"], case["v"], case["bias"])
    got = flash_decode(*args, softcap=case["softcap"])
    torch.cuda.synchronize()
    want = flash_decode_ref(*args, softcap=case["softcap"])
    tol = 1e-5 if case["q"].dtype == torch.float32 else 1e-3
    live = (case["bias"] == 0).any(dim=1)            # rows with a valid slot
    o_g = got[0] / got[2][..., None]
    o_w = want[0] / want[2][..., None]
    errs = {}
    for name, a, b in (("o/l", o_g, o_w), ("m", got[1], want[1]),
                       ("l", got[2], want[2])):
        a, b = a[live], b[live]
        errs[name] = ((a - b).abs().max() / b.abs().max()).item()
        if not errs[name] <= tol:
            raise AssertionError(f"flash_decode {name}: relative error "
                                 f"{errs[name]:.3e} > {tol:g}")
    if (~live).any():
        S = case["k"].shape[1]
        if not ((got[1][~live] == -1e30).all()
                and (got[2][~live] == S).all()):
            raise AssertionError("fully masked row: want m=-1e30, l=S")
    errs["max_abs_err"] = (o_g[live] - o_w[live]).abs().max().item()
    return errs


def roofline(moved: float, flops: float, dtype) -> tuple:
    """Least time the card needs for a call, in ms, and what bounds it:
    the bytes it must move (each input read once, each output written
    once) over the HBM rate vs its operations over the peak rate of the
    inputs' type."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def cold_copies(args) -> list:
    """``args`` and enough clones of it to hold about twice the L2, so a
    call that cycles through them finds its inputs cold."""
    n = min(255, int(2 * L2_BYTES // max(nbytes(*args), 1)))
    return [args] + [tuple(None if t is None else t.clone() for t in args)
                     for _ in range(n)]


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def bound(case) -> tuple:
    """Flash-decode: q, K, V and the bias in, o, m, l out; 4·B·H·S·dh
    flops (q·k and p·v)."""
    q, k = case["q"], case["k"]
    B, H, dh = q.shape
    S = k.shape[1]
    moved = nbytes(q, k, case["v"], case["bias"]) + (B * H * dh
                                                     + 2 * B * H) * 4
    return roofline(moved, 4 * B * H * S * dh, q.dtype)


def time_case(case) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
    args = (case["q"], case["k"], case["v"], case["bias"])
    sc = case["softcap"]
    copies = cold_copies(args)
    # yardstick only: one PyTorch call over the same cache (the port never
    # calls it), in its own [B, heads, S, dh] layout made outside the timing
    sdpa_args = [(q[:, :, None, :], k.transpose(1, 2).contiguous(),
                  v.transpose(1, 2).contiguous(), (b == 0)[:, None, None, :])
                 for q, k, v, b in copies]
    b_ms, b_by = bound(case)
    return {
        "ms": time_ms(lambda *a: flash_decode(*a, softcap=sc), copies),
        "plain_ms": time_ms(lambda *a: flash_decode_ref(*a, softcap=sc),
                            copies),
        "library_ms": time_ms(
            lambda q, k, v, mask: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True), sdpa_args),
        "bound_ms": b_ms, "bound_by": b_by}


def phase_kernels() -> dict:
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    timed = {}
    for B, S in ((1, 2048), (8, 2048), (PROMPT_B, PROMPT_T + N_NEW)):
        case = decode_case(B, S, 64, bf16, seed=B * S)
        errs = check_case(case)
        t = time_case(case)
        timed[(B, S)] = dict(t, max_abs_err=errs["max_abs_err"])
        print(f"[kernel] flash_decode bf16 B={B} S={S} H={N_HEADS} "
              f"Hk={N_KV} dh=64: err o/l {errs['o/l']:.2e} m {errs['m']:.2e}"
              f" l {errs['l']:.2e} (tol 1e-3) | kernel {t['ms']*1e3:.2f} us"
              f", bound {t['bound_ms']*1e3:.2f} us ({t['bound_by']}), plain "
              f"{t['plain_ms']*1e3:.2f} us, sdpa yardstick "
              f"{t['library_ms']*1e3:.2f} us", flush=True)
    extra = (
        ("f32 B=8 S=2048", decode_case(8, 2048, 64, f32, seed=1)),
        ("f32 B=4 S=48, row 0 fully masked",
         decode_case(4, 48, 64, f32, seed=2, masked_row=True)),
        ("bf16 B=8 S=2048 window=256 softcap=50",
         decode_case(8, 2048, 64, bf16, seed=3, window=256, softcap=50.0)),
        ("bf16 B=4 S=2048 dh=128", decode_case(4, 2048, 128, bf16, seed=4)),
        ("bf16 B=4 S=48, row 0 fully masked",
         decode_case(4, 48, 64, bf16, seed=5, masked_row=True)),
    )
    for label, case in extra:
        errs = check_case(case)
        tol = "1e-5" if case["q"].dtype == torch.float32 else "1e-3"
        print(f"[kernel] flash_decode {label}: err o/l {errs['o/l']:.2e} "
              f"m {errs['m']:.2e} l {errs['l']:.2e} (tol {tol})", flush=True)
    return timed


# ---------------------------------------------------------------------------
# phase 3: paged flash-decode against its plain version
# ---------------------------------------------------------------------------

def paged_case(B, ps, MP, dh, dtype, *, seed, softcap=None, shuffled=True,
               shared=False, trash=True, masked_row=False):
    """Pools of P = B·MP pages plus the trash page (id P); ragged lengths;
    each row's pages drawn from a permutation of the page ids (or in
    order), table entries past a row's pages on the trash page (or on
    other pages); ``shared`` points row 1's first pages at row 0's."""
    import torch
    from repro_torch.kernels.flash_decode import validity_bias
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)
    P = B * MP
    q = randn(B, N_HEADS, dh)
    k_pool = randn(P + 1, ps, N_KV, dh)
    v_pool = randn(P + 1, ps, N_KV, dh)
    lens = torch.randint(1, MP * ps + 1, (B,), generator=g, device="cuda")
    if masked_row:
        lens[0] = 0
    ids = (torch.randperm(P, generator=g, device="cuda") if shuffled
           else torch.arange(P, device="cuda")).reshape(B, MP)
    if trash:
        used = (lens[:, None] + ps - 1) // ps
        col = torch.arange(MP, device="cuda")[None]
        ids = torch.where(col < used, ids, P)
    if shared and B > 1:
        n = int(min(lens[0], lens[1]).item()) // ps
        ids[1, :n] = ids[0, :n]
    bias = validity_bias(B, MP * ps, lens, device="cuda")
    return dict(args=(q, k_pool, v_pool, ids.to(torch.int32).contiguous(),
                      bias), lens=lens, softcap=softcap)


def check_paged(label: str, case) -> float:
    """Paged kernel vs its plain version (gather + dense math) → max abs
    error of o/l; raises past the tolerance.  A fully masked row must give
    m = -1e30 and l = MP·ps exactly."""
    import torch
    from repro_torch.kernels.flash_decode import (flash_decode_paged,
                                                  flash_decode_paged_ref)
    args, cap = case["args"], case["softcap"]
    got = flash_decode_paged(*args, softcap=cap)
    torch.cuda.synchronize()
    want = flash_decode_paged_ref(*args, softcap=cap)
    tol = _tol(args[0].dtype)
    live = case["lens"] > 0
    o_g = got[0] / got[2][..., None]
    o_w = want[0] / want[2][..., None]
    errs = {}
    for name, a, b in (("o/l", o_g, o_w), ("m", got[1], want[1]),
                       ("l", got[2], want[2])):
        a, b = a[live], b[live]
        errs[name] = ((a - b).abs().max() / b.abs().max()).item()
        if not errs[name] <= tol:
            raise AssertionError(f"flash_decode_paged {label} {name}: "
                                 f"relative error {errs[name]:.3e} > {tol:g}")
    if (~live).any():
        S = args[3].shape[1] * args[1].shape[1]
        if not ((got[1][~live] == -1e30).all()
                and (got[2][~live] == S).all()):
            raise AssertionError(f"flash_decode_paged {label}: fully masked "
                                 f"row: want m=-1e30, l={S}")
    print(f"[kernel] flash_decode_paged {label}: err o/l {errs['o/l']:.2e} m "
          f"{errs['m']:.2e} l {errs['l']:.2e} (tol {tol:g})", flush=True)
    return (o_g[live] - o_w[live]).abs().max().item()


def paged_bound(case) -> tuple:
    """Paged flash-decode: q, the page table, the bias and the K and V rows
    of the distinct valid positions in, o, m, l out; 4·H·dh flops per valid
    position of each row (q·k and p·v).  A masked position adds exactly 0,
    and each position's K or V row is contiguous, so only the positions
    below each row's length count, once each however many rows share
    them."""
    import torch
    q, k_pool, _, table, bias = case["args"]
    B, H, dh = q.shape
    ps, Hk = k_pool.shape[1], k_pool.shape[2]
    lens = case["lens"]
    j = torch.arange(table.shape[1] * ps, device=table.device)
    slots = table[:, j // ps].long() * ps + j % ps        # [B, MP·ps]
    positions = slots[j[None] < lens[:, None]].unique().numel()
    row_bytes = Hk * dh * k_pool.element_size()
    moved = (nbytes(q, table, bias) + 2 * positions * row_bytes
             + (B * H * dh + 2 * B * H) * 4)
    return roofline(moved, 4 * H * dh * int(lens.sum()), q.dtype)


def time_paged(case) -> dict:
    """Kernel, plain version, the two-call yardstick (``gather_pages`` then
    sdpa; no one PyTorch call computes paged attention), and the dense
    flash-decode kernel on the already gathered cache (what the page-table
    indirection costs)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_paged,
                                                  flash_decode_paged_ref,
                                                  gather_pages)
    cap = case["softcap"]
    copies = cold_copies(case["args"])

    def gathered_sdpa(q, k_pool, v_pool, table, bias):
        k = gather_pages(k_pool, table).transpose(1, 2)
        v = gather_pages(v_pool, table).transpose(1, 2)
        return F.scaled_dot_product_attention(
            q[:, :, None, :], k, v, attn_mask=(bias == 0)[:, None, None, :],
            enable_gqa=True)
    dense = [(q, gather_pages(k, t).contiguous(),
              gather_pages(v, t).contiguous(), b)
             for q, k, v, t, b in copies[:max(2, len(copies) // 4)]]
    b_ms, b_by = paged_bound(case)
    return {
        "ms": time_ms(lambda *a: flash_decode_paged(*a, softcap=cap), copies),
        "plain_ms": time_ms(
            lambda *a: flash_decode_paged_ref(*a, softcap=cap), copies),
        "library_ms": None,
        "yardstick_ms": time_ms(gathered_sdpa, copies),
        "dense_ms": time_ms(lambda *a: flash_decode(*a, softcap=cap), dense),
        "bound_ms": b_ms, "bound_by": b_by}


def phase_paged_kernel() -> dict:
    """The paged kernel at the serving shape (8 rows, ps 16, 16 pages a
    row, 32/8 heads, dh 64, bf16, ragged lengths, shuffled pages, trash
    entries) and at harder ones; the main shape timed."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    main = paged_case(8, 16, 16, 64, bf16, seed=30)
    err = check_paged("bf16 B=8 ps=16 MP=16 dh=64 (serving shape)", main)
    for label, case in (
            ("bf16 ps=8 MP=32", paged_case(8, 8, 32, 64, bf16, seed=31)),
            ("bf16 dh=128 ps=16", paged_case(4, 16, 8, 128, bf16, seed=32)),
            ("f32 ps=16", paged_case(8, 16, 16, 64, f32, seed=33)),
            ("f32 ps=8 dh=128 softcap=50",
             paged_case(4, 8, 12, 128, f32, seed=34, softcap=50.0)),
            ("bf16 softcap=50", paged_case(8, 16, 16, 64, bf16, seed=35,
                                           softcap=50.0)),
            ("bf16 pages in order, no trash",
             paged_case(8, 16, 16, 64, bf16, seed=36, shuffled=False,
                        trash=False)),
            ("f32 rows 0 and 1 sharing pages",
             paged_case(4, 16, 16, 64, f32, seed=37, shared=True)),
            ("bf16 ps=5 (no power of two), shared",
             paged_case(4, 5, 40, 64, bf16, seed=38, shared=True)),
            ("f32 row 0 fully masked", paged_case(4, 16, 16, 64, f32,
                                                  seed=39, masked_row=True)),
            ("bf16 row 0 fully masked, ps=8",
             paged_case(4, 8, 16, 64, bf16, seed=40, masked_row=True))):
        check_paged(label, case)
    t = dict(time_paged(main), max_abs_err=err)
    print(f"[kernel] flash_decode_paged serving shape: kernel "
          f"{t['ms']*1e3:.2f} us, bound {t['bound_ms']*1e3:.2f} us "
          f"({t['bound_by']}), plain {t['plain_ms']*1e3:.2f} us, two-call "
          f"yardstick gather_pages + sdpa {t['yardstick_ms']*1e3:.2f} us, "
          f"dense flash_decode on the gathered cache {t['dense_ms']*1e3:.2f}"
          f" us", flush=True)
    return t


# ---------------------------------------------------------------------------
# phase 4: the session at full width
# ---------------------------------------------------------------------------

def timed_generate(session, prompt, n_new, plan):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = session.generate(prompt, n_new, plan=plan)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_small_reference() -> None:
    """A small f32 model decoded on the card (flash-decode kernel) agrees
    with the same weights decoded on the CPU (plain version)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.exchange import ExchangeConfig
    from repro_torch.models import registry
    from repro_torch.models import transformer as tfm
    cfg = get_config(ARCH).reduced(dtype="float32", head_dim=64, n_heads=8,
                                   n_kv_heads=2, d_model=256)
    params = registry.init_params(cfg, seed=0, device="cuda")

    def to_cpu(t):
        if isinstance(t, dict):
            return {k: to_cpu(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_cpu(v) for v in t]
        return t.cpu()
    sides = {"cuda": params, "cpu": to_cpu(params)}
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(0))
    worst = 0.0
    with torch.inference_mode():
        caches = {d: tfm.init_decode_cache(cfg, 2, 12, device=d)
                  for d in sides}
        for t in range(12):
            logits = {}
            for d, p in sides.items():
                logits[d], caches[d] = tfm.decode_step(
                    p, {"tokens": toks[:, t:t + 1].to(d)}, caches[d], t, cfg,
                    ExchangeConfig())
            worst = max(worst, (logits["cuda"].cpu() - logits["cpu"]).abs()
                        .max().item())
    if not worst <= 1e-4:
        raise AssertionError(f"small f32 model: card vs CPU decode logits "
                             f"differ by {worst:.3e} > 1e-4")
    print(f"[reference] reduced f32 llama (2 layers, dh 64): 12 decode steps "
          f"on the card vs the CPU, max |logit diff| {worst:.2e} (tol 1e-4)",
          flush=True)


def phase_session(card: str) -> int:
    import torch
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.kernels.flash_decode import flash_decode
    t0 = time.perf_counter()
    session = InferenceSession.from_config(
        ARCH, reduced=False, device="cuda",
        plans=[ExecutionPlan.local(), ExecutionPlan.prism_sim(L=4, cr=9.9)])
    cfg = session.cfg
    session.profile(backend="simulated")
    torch.cuda.synchronize()
    print(f"[session] {cfg.name} full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, dh {cfg.hd},"
          f" vocab {cfg.vocab_size}, {cfg.dtype}) built and profiled in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for B in (1, 8, 32):
        d = session.decide(B)
        x = session.explain(B)
        print(f"[decide] B={B} @ {session.bandwidth:g} Mbps → {d.mode}"
              + (f" CR={d.cr:g}" if d.cr else "")
              + f" ({d.expected.per_sample_ms:.1f} ms/sample modeled), plan "
              f"{x.plan_key!r}, batch crossover {x.batch_crossover}, "
              f"bandwidth crossover {x.bandwidth_crossover}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (8, 64), generator=g,
                           device="cuda")
    logits = session.dispatch({"tokens": tokens})
    rec = session.history[-1]
    if logits.shape != (8, 64, cfg.vocab_size) or not torch.isfinite(
            logits).all():
        raise AssertionError(f"dispatch logits {tuple(logits.shape)} not "
                             f"finite / wrong shape")
    print(f"[dispatch] tokens [8, 64] → plan {rec.exec_key!r}, logits "
          f"{tuple(logits.shape)} finite, {rec.wall_ms:.1f} ms", flush=True)
    del logits

    prompt = torch.randint(0, cfg.vocab_size, (PROMPT_B, PROMPT_T),
                           generator=g, device="cuda")
    steps = {"local": N_NEW - 1, "prism@9.9": PROMPT_T + N_NEW - 1}
    total = 0
    for key, n_steps in steps.items():
        plan = session.plans[key]
        timed_generate(session, prompt, 2, plan)                 # warm-up
        _, w1 = timed_generate(session, prompt, 1, plan)
        flash_decode.launches = 0
        out, w = timed_generate(session, prompt, N_NEW, plan)
        launches = flash_decode.launches
        want = n_steps * cfg.n_layers
        if launches != want:
            raise AssertionError(f"{key}: flash_decode launched {launches} "
                                 f"times, want {want}")
        if out.shape != (PROMPT_B, N_NEW) or not (
                (out >= 0) & (out < cfg.vocab_size)).all():
            raise AssertionError(f"{key}: bad tokens {tuple(out.shape)}")
        seq = torch.cat([prompt, out.to(prompt.dtype)], dim=1)
        lg = session.run(key, {"tokens": seq})
        if not torch.isfinite(lg).all():
            raise AssertionError(f"{key}: non-finite logits over the "
                                 f"generated sequence")
        del lg
        decode_ms = (w - w1) / (N_NEW - 1)
        print(f"[generate] {key}: [{PROMPT_B}, {PROMPT_T}] prompt + {N_NEW} "
              f"greedy tokens in {w:.1f} ms; flash_decode launches "
              f"{launches} (= {n_steps} steps x {cfg.n_layers} layers); "
              f"decode {decode_ms:.2f} ms/token step, "
              f"{PROMPT_B / decode_ms * 1e3:.1f} tokens/s at B={PROMPT_B} "
              f"[{card}]", flush=True)
        total += launches
        if key == "local":
            print_breakdown(key, lambda: session.generate(prompt, N_NEW,
                                                          plan=plan), w)
    return total, session


# ---------------------------------------------------------------------------
# phases 4 and 7: serving through the slot pool and the paged pool
# ---------------------------------------------------------------------------

SMALL_LLAMA = dict(dtype="float32", head_dim=64, n_heads=8, n_kv_heads=2,
                   d_model=256)


def _serve_all(rt, prompts, n_new):
    """Submit every prompt at once (greedy, seed = index) and run the
    runtime dry → tokens in submission order."""
    reqs = [rt.submit(p, n_new, seed=i) for i, p in enumerate(prompts)]
    done = {c.request_id: c.tokens for c in rt.run()}
    return [done[r.id] for r in reqs]


def phase_small_serving() -> None:
    """A small f32 llama served by ``ServingRuntime`` on the card, dense
    and paged, under ``local`` and ``prism_sim``, against the same weights
    served on the CPU: greedy tokens exact, equal page/prefix counters, and
    the prefix entries' logits (the paged pool's prefill and suffix
    passes) within 1e-4.  The traffic makes a miss, a full hit and two
    partial hits on an unaligned prompt (copy-on-write tail splits)."""
    import numpy as np
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.serving import ServingRuntime
    cfg = get_config(ARCH).reduced(**SMALL_LLAMA)
    params = registry.init_params(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(7)
    base = list(rng.randint(1, cfg.vocab_size, 21))   # 2 pages + 5 @ ps 8
    prompts = [base, base, base + [11, 12, 13], base + [14],
               list(rng.randint(1, cfg.vocab_size, 11))]
    t0 = time.perf_counter()
    for mode in ("local", "prism"):
        runs = {}
        for dev in ("cuda", "cpu"):
            session = InferenceSession.from_config(
                ARCH, reduced=SMALL_LLAMA, device=dev,
                params=_on(params, dev), allow_modes=(mode,),
                plans=[ExecutionPlan.local(),
                       ExecutionPlan.prism_sim(L=4, cr=9.9)])
            session.profile(backend="simulated")
            dense = ServingRuntime(session, n_slots=2, chunk=4, max_len=40)
            paged = ServingRuntime(session, chunk=4, max_len=40,
                                   page_size=8, n_pages=32, n_rows=3)
            runs[dev] = (_serve_all(dense, prompts, 9),
                         _serve_all(paged, prompts, 9),
                         next(iter(paged.pools.values())),
                         paged.stats_snapshot())
        (d_gpu, p_gpu, pool_gpu, st_gpu), (d_cpu, p_cpu, pool_cpu,
                                            st_cpu) = runs["cuda"], runs["cpu"]
        for a, b in zip(d_gpu + p_gpu, d_cpu + p_cpu):
            if not np.array_equal(a, b):
                raise AssertionError(f"small serving {mode}: card tokens "
                                     f"{a} vs CPU {b}")
        keys = ("prefix_hits", "full_hits", "partial_hits", "cow_splits",
                "prefix_misses")
        if [st_gpu[k] for k in keys] != [st_cpu[k] for k in keys] or (
                st_gpu["full_hits"], st_gpu["partial_hits"]) != (1, 2):
            raise AssertionError(f"small serving {mode}: counters "
                                 f"{[st_gpu[k] for k in keys]} (card) vs "
                                 f"{[st_cpu[k] for k in keys]} (CPU)")
        worst = max((e.logits.cpu() - pool_cpu.prefix.entries[d].logits)
                    .abs().max().item()
                    for d, e in pool_gpu.prefix.entries.items())
        if not worst <= 1e-4:
            raise AssertionError(f"small serving {mode}: prefix-entry "
                                 f"logits differ by {worst:.3e} > 1e-4")
        for pool in (pool_gpu, pool_cpu):
            pool.alloc.check()
        print(f"[reference] reduced f32 llama served on the card vs the CPU "
              f"({mode}): {len(prompts)} requests x 9 tokens, dense (2 "
              f"slots) and paged (ps 8) token-exact; paged counters equal "
              f"({st_gpu['full_hits']} full / {st_gpu['partial_hits']} "
              f"partial hits, {st_gpu['cow_splits']} COW splits); "
              f"prefix-entry logits max |diff| {worst:.2e} (tol 1e-4)",
              flush=True)
    print(f"[reference] small serving in {time.perf_counter() - t0:.1f} s",
          flush=True)


SERVE_ROWS, SERVE_CHUNK, SERVE_PS, SERVE_PAGES = 8, 8, 16, 512
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_NEW, SYSTEM_LEN = 4, 256, 32, 128


def serve_traffic(vocab: int):
    """The serve phase's 24 greedy requests: 16 extend one 128-token system
    prompt with 16–64-token suffixes, 8 have disjoint 64–192-token
    prompts, interleaved; and the system prompt itself."""
    import numpy as np
    rng = np.random.RandomState(0)
    system = rng.randint(0, vocab, SYSTEM_LEN)
    shared = [np.concatenate([system, rng.randint(0, vocab,
                                                  rng.randint(16, 65))])
              for _ in range(16)]
    disjoint = [rng.randint(0, vocab, rng.randint(64, 193))
                for _ in range(8)]
    prompts = shared + disjoint
    order = rng.permutation(len(prompts))
    return system, [prompts[i] for i in order], [int(i < 16) for i in order]


def _drive(rt, prompts, n_new):
    """Submit every prompt at once and step the runtime dry, tracking the
    peak page occupancy and each request's first streamed tokens → (per
    request tokens, completions, wall s, peak occupancy, TTFT ms)."""
    import torch
    first = {}
    rt.on_progress = lambda rid, toks: first.setdefault(rid,
                                                        time.monotonic())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [rt.submit(p, n_new, seed=i) for i, p in enumerate(prompts)]
    peak, comps = 0.0, []
    while rt.queue or not rt.idle:
        comps += rt.step()
        if rt.paged:
            peak = max(peak, rt.stats_snapshot()["page_occupancy"])
    wall = time.perf_counter() - t0
    rt.on_progress = None
    done = {c.request_id: c.tokens for c in comps}
    ttft = [1e3 * (first[r.id] - r.arrival_ts) for r in reqs]
    return [done[r.id] for r in reqs], comps, wall, peak, ttft


def _chunk_idle(rt, prompts) -> str:
    """Device busy and idle share of one decode chunk: submit a pool's
    worth of requests, take one step (the scheduler admits what the policy
    forms), then profile one chunk and time that same chunk on the host
    clock, so busy and wall come from one chunk; the next chunk, unprofiled,
    is timed too, to show what the profiler adds to the wall.  Then
    drain."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i, p in enumerate(prompts[:rt.n_slots]):
        rt.submit(p, SERVE_NEW, seed=i)
    rt.step()
    pool = next(iter(rt.pools.values()))
    active = pool.n_active
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool.decode_chunk(SERVE_CHUNK)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pool.decode_chunk(SERVE_CHUNK)
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) * 1e3
    ms = collections.Counter()
    for e in prof.events():
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            ms[e.name] += e.self_device_time_total / 1e3
    rt.run()
    if not ms:
        return "the profiler saw no device time"
    busy = sum(ms.values())
    attn = sum(v for n, v in ms.items() if "flash_decode" in n)
    return (f"one chunk of {SERVE_CHUNK} steps, {active} active "
            f"rows: kernels busy {busy:.2f} ms of that chunk's {wall:.1f} ms "
            f"wall under the profiler (device idle {1 - busy / wall:.1%}; "
            f"the next chunk, unprofiled, {plain_wall:.1f} ms wall), "
            f"attention kernel {attn:.3f} ms")


def _time_admissions(pool) -> list:
    """Wrap ``pool.admit`` so that every admission (prefill, or prefix hit
    and suffix pass) is timed on the host clock between two synchronises;
    the same for either pool, so their walls pay the same.  → a one-item
    list that holds the seconds so far."""
    import torch
    total = [0.0]
    admit = pool.admit

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = admit(*args, **kw)
        torch.cuda.synchronize()
        total[0] += time.perf_counter() - t0
        return out
    pool.admit = timed
    return total


def phase_serve(card: str, base) -> tuple:
    """llama3.2-1b at full width (the session of the ``session`` phase,
    ``local`` pinned so every request shares one pool) served by
    ``ServingRuntime``: the paged pool (page size 16, 8 rows, chunk 8, 512
    pages) after the system prompt warmed its prefix cache, then the dense
    slot pool (4 slots, max_len 256), each over the same 24 requests.
    Launch counts, hits and the allocator are asserted; throughput,
    latency, time to first token, step time, idle share and agreement
    with B=1 ``generate`` printed.  → (dense flash-decode launches, paged
    launches) of the two runs."""
    import numpy as np
    import torch
    from repro_torch.api import InferenceSession
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_paged)
    from repro_torch.serving import ServingRuntime, StragglerHook
    session = InferenceSession(base.cfg, base.params,
                               list(base.plans.values()),
                               allow_modes=("local",), device="cuda")
    session.profile(backend="simulated")
    cfg = session.cfg
    system, prompts, extends = serve_traffic(cfg.vocab_size)
    n_tok = len(prompts) * SERVE_NEW
    out, launches = {}, {}
    for kind in ("paged", "dense"):
        hook = StragglerHook(n_devices=1)
        kw = (dict(page_size=SERVE_PS, n_pages=SERVE_PAGES,
                   n_rows=SERVE_ROWS) if kind == "paged"
              else dict(n_slots=SERVE_SLOTS))
        rt = ServingRuntime(session, chunk=SERVE_CHUNK,
                            max_len=SERVE_MAX_LEN, straggler_hook=hook, **kw)
        rt.submit(system, 8)                       # warms the prefix cache
        rt.run()
        admit_s = _time_admissions(next(iter(rt.pools.values())))
        before = rt.stats_snapshot()
        hook.chunk_walls_ms.clear()
        flash_decode.launches = flash_decode_paged.launches = 0
        toks, comps, wall, peak, ttft = _drive(rt, prompts, SERVE_NEW)
        launches[kind] = (flash_decode.launches, flash_decode_paged.launches)
        after = rt.stats_snapshot()
        steps = (after["chunks"] - before["chunks"]) * SERVE_CHUNK
        if kind == "paged":
            d = {k: after[k] - before[k] for k in
                 ("prefix_hits", "partial_hits", "full_hits",
                  "prefix_misses")}
            want = {"prefix_hits": 16, "partial_hits": 16, "full_hits": 0,
                    "prefix_misses": 8}
            if d != want:
                raise AssertionError(f"serve paged: hits {d}, the traffic "
                                     f"implies {want}")
            suffix = sum(len(p) - SYSTEM_LEN
                         for p, e in zip(prompts, extends) if e)
            want_l = (0, cfg.n_layers * (steps + suffix))
            pool = next(iter(rt.pools.values()))
            pool.alloc.check()
            for digest in list(pool.prefix.entries):
                pool.prefix.evict_entry(digest)
            pool.alloc.check()
            if (len(pool.alloc.free) != SERVE_PAGES or pool.alloc.refs
                    or pool.alloc.committed):
                raise AssertionError("serve paged: pages leaked after the "
                                     "drain")
            extra = (f"; prefix hit rate {d['prefix_hits'] / 24:.1%} "
                     f"({d['partial_hits']} partial hits, "
                     f"{suffix} suffix tokens), peak page occupancy "
                     f"{peak:.1%} of {SERVE_PAGES} pages; after the drain "
                     f"the allocator checks clean and every page is free")
            expect = (f"flash_decode_paged launches {launches[kind][1]} = "
                      f"{cfg.n_layers} layers x ({steps} decode steps + "
                      f"{suffix} suffix tokens)")
        else:
            want_l = (cfg.n_layers * steps, 0)
            extra = ""
            expect = (f"flash_decode launches {launches[kind][0]} = "
                      f"{cfg.n_layers} layers x {steps} decode steps")
        if launches[kind] != want_l:
            raise AssertionError(f"serve {kind}: (flash_decode, "
                                 f"flash_decode_paged) launches "
                                 f"{launches[kind]}, want {want_l}")
        for t in toks:
            if t.shape != (SERVE_NEW,) or not ((t >= 0)
                                               & (t < cfg.vocab_size)).all():
                raise AssertionError(f"serve {kind}: bad tokens {t}")
        lat = [c.latency_ms for c in comps]
        step_ms = statistics.median(hook.chunk_walls_ms)
        print(f"[serve] {kind}: {len(prompts)} requests x {SERVE_NEW} greedy "
              f"tokens in {wall:.2f} s: {len(prompts) / wall:.2f} requests/s,"
              f" {n_tok / wall:.1f} tokens/s; latency p50 "
              f"{np.percentile(lat, 50):.0f} ms p99 "
              f"{np.percentile(lat, 99):.0f} ms; time to first token p50 "
              f"{np.percentile(ttft, 50):.0f} ms p99 "
              f"{np.percentile(ttft, 99):.0f} ms; decode {step_ms:.2f} ms "
              f"per chunk step (median); admissions {admit_s[0]:.2f} s of the "
              f"run (synchronised before and after each, in both pools); "
              f"{expect}{extra} [{card}]", flush=True)
        print(f"[serve] {kind} idle: {_chunk_idle(rt, prompts)} [{card}]",
              flush=True)
        out[kind] = toks

    exact, first_div = 0, []
    for p, a, b in zip(prompts, out["paged"], out["dense"]):
        ref = session.generate(torch.as_tensor(p)[None], SERVE_NEW)[0]
        ref = ref.cpu().numpy()
        for t in (a, b):
            diff = np.nonzero(t != ref)[0]
            exact += not diff.size
            if diff.size:
                first_div.append(int(diff[0]))
    same = sum(np.array_equal(a, b) for a, b in zip(out["paged"],
                                                    out["dense"]))
    print(f"[serve] greedy agreement with B=1 session.generate: "
          f"{exact}/{2 * len(prompts)} requests exact over both runs (bf16: "
          f"batches round differently; no threshold), first divergences at "
          f"token {sorted(first_div)}; paged = dense on {same}/"
          f"{len(prompts)} [{card}]", flush=True)
    return launches["dense"][0], launches["paged"][1]


def print_breakdown(key: str, fn, wall_ms: float) -> None:
    """Kernel time on the card during one ``fn()`` (torch.profiler), beside
    the same call's wall time measured without the profiler."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms = collections.Counter()
    for e in prof.events():
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            ms[e.name] += e.self_device_time_total / 1e3
    if not ms:
        print(f"[profile] {key}: the profiler saw no device time",
              flush=True)
        return
    busy = sum(ms.values())
    fd = sum(v for n, v in ms.items() if "flash_decode_kernel" in n)
    top = "; ".join(f"{n[:48]} {v:.2f} ms" for n, v in ms.most_common(5))
    print(f"[profile] {key} generate: kernels busy {busy:.2f} ms of "
          f"{wall_ms:.1f} ms wall (device idle {1 - busy / wall_ms:.1%}); "
          f"flash_decode {fd:.3f} ms ({fd / busy:.1%} of busy); "
          f"{len(ms)} kernel names; top: {top}", flush=True)


# ---------------------------------------------------------------------------
# phase 3: segment means and PRISM attention against their plain versions
# ---------------------------------------------------------------------------

def _tol(dtype) -> float:
    import torch
    return 1e-5 if dtype == torch.float32 else 1e-3


def seg_case(B, N, feat, L, dtype, *, seed, masked=True):
    """[B, N, *feat] inputs; the mask pads each row's tail, as ViT's, and
    empties the first segment of row 0."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, N, *feat, generator=g, device="cuda").to(dtype)
    mask = None
    if masked:
        mask = torch.rand(B, N, generator=g, device="cuda") > 0.1
        mask[:, -3:] = False
        mask[0, :N // L] = False
    return x.reshape(B, N, -1), L, mask


def check_seg(label: str, case) -> float:
    """Kernel vs plain version → max abs error; raises past tolerance."""
    import torch
    from repro_torch.kernels.segment_means import (segment_means,
                                                   segment_means_ref)
    x, L, mask = case
    got, got_c = segment_means(x, L, mask)
    torch.cuda.synchronize()
    want, want_c = segment_means_ref(x, L, mask)
    err, tol = rel_err(got, want), _tol(x.dtype)
    if not err <= tol:
        raise AssertionError(f"segment_means {label}: relative error "
                             f"{err:.3e} > {tol:g}")
    if not torch.equal(got_c, want_c):
        raise AssertionError(f"segment_means {label}: counts differ")
    print(f"[kernel] segment_means {label}: rel err {err:.2e} (tol {tol:g})"
          f", counts exact", flush=True)
    return (got.float() - want.float()).abs().max().item()


def time_seg(case) -> dict:
    import torch
    from repro_torch.kernels.segment_means import (segment_means,
                                                   segment_means_ref)
    x, L, mask = case
    B, N, D = x.shape
    copies = cold_copies((x, mask))
    moved = nbytes(x, mask) + B * L * D * x.element_size() + B * L * 4
    b_ms, b_by = roofline(moved, 2 * B * N * D, x.dtype)   # x·mask, add
    # yardstick only: one PyTorch call, unmasked (the port never calls it)
    return {
        "ms": time_ms(lambda x, m: segment_means(x, L, m), copies),
        "plain_ms": time_ms(lambda x, m: segment_means_ref(x, L, m), copies),
        "library_ms": time_ms(
            lambda x, m: x.unflatten(1, (L, N // L)).mean(
                2, dtype=torch.float32), copies),
        "bound_ms": b_ms, "bound_by": b_by}


def prism_case(B, Np, H, Hk, dh, P, L, dtype, *, seed, causal=False,
               part=0, masked=True, softcap=None, dead_row=False):
    """Local q/K/V of one partition, every partition's means, and the
    mean bias built as the exchange builds it (own partition hidden; with a
    mask, per-segment counts, one segment empty)."""
    import torch
    from repro_torch.kernels.prism_attention import build_mean_bias
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)
    q, k, v = randn(B, Np, H, dh), randn(B, Np, Hk, dh), randn(B, Np, Hk, dh)
    km, vm = randn(B, P * L, Hk, dh), randn(B, P * L, Hk, dh)
    mask = counts = None
    if masked:
        mask = torch.rand(B, Np, generator=g, device="cuda") > 0.1
        mask[:, -3:] = False
        counts = torch.randint(1, Np // L + 1, (B, P, L), generator=g,
                               device="cuda").float()
        counts[0, -1, -1] = 0
        if dead_row:                      # batch row 0 sees no key at all
            mask[0] = False
            counts[0] = 0
    bias = build_mean_bias(B, P, L, part, Np // L, causal=causal,
                           mean_counts=counts, device="cuda")
    return dict(args=(q, k, v, km, vm, bias, mask), causal=causal,
                softcap=softcap)


def _prism_calls(case):
    from repro_torch.kernels.prism_attention import (prism_attention,
                                                     prism_attention_ref)
    causal, cap = case["causal"], case["softcap"]

    def kernel(q, k, v, km, vm, bias, mask, out_dtype=None):
        return prism_attention(q, k, v, km, vm, bias, causal=causal,
                               softcap=cap, kv_mask=mask, out_dtype=out_dtype)

    def plain(q, k, v, km, vm, bias, mask, out_dtype=None):
        return prism_attention_ref(q, k, v, km, vm, bias, causal=causal,
                                   logit_softcap=cap, kv_mask=mask,
                                   out_dtype=out_dtype)
    return kernel, plain


def check_prism(label: str, case) -> float:
    """Kernel vs plain version on the f32 result before the final rounding
    to the inputs' type (relative max error within tolerance), and on the
    output as the serving path gets it (bf16: every element within one
    bf16 rounding step, 2^-7 relative, of the plain version's)."""
    import torch
    kernel, plain = _prism_calls(case)
    got32 = kernel(*case["args"], out_dtype=torch.float32)
    got = kernel(*case["args"])
    torch.cuda.synchronize()
    want32 = plain(*case["args"], out_dtype=torch.float32)
    want = plain(*case["args"])
    dtype = case["args"][0].dtype
    err, tol = rel_err(got32, want32), _tol(dtype)
    if not err <= tol or not torch.isfinite(got32).all():
        raise AssertionError(f"prism_attention {label}: relative error "
                             f"{err:.3e} > {tol:g} (or not finite)")
    step = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    scale = want.float().abs().max().item()
    if not torch.isclose(got.float(), want.float(), rtol=step,
                         atol=1e-6 * scale).all():
        raise AssertionError(f"prism_attention {label}: {dtype} output "
                             f"off by more than one rounding step")
    print(f"[kernel] prism_attention {label}: rel err {err:.2e} (tol "
          f"{tol:g}) before the cast; {str(dtype)[6:]} output within "
          f"{step:.2g} relative", flush=True)
    return (got.float() - want.float()).abs().max().item()


def time_prism(case) -> dict:
    import torch
    import torch.nn.functional as F
    kernel, plain = _prism_calls(case)
    q, k, v, km, vm, bias, mask = case["args"]
    B, Nq, H, dh = q.shape
    Nk, M = k.shape[1], km.shape[1]
    copies = cold_copies(case["args"])
    moved = nbytes(*case["args"]) + nbytes(q)                 # + output
    b_ms, b_by = roofline(moved, 4 * B * H * Nq * (Nk + M) * dh, q.dtype)

    # yardstick only: sdpa over [K_loc ‖ K_means] with the bias as a float
    # mask, in its own [B, heads, N, dh] layout made outside the timing
    def sdpa_args(q, k, v, km, vm, bias, mask):
        keys = torch.where(mask, 0.0, -1e30) if mask is not None else \
            torch.zeros(B, Nk, device=q.device)
        full = torch.cat([keys, bias], dim=1).to(q.dtype)
        return (q.transpose(1, 2), torch.cat([k, km], 1).transpose(1, 2)
                .contiguous(), torch.cat([v, vm], 1).transpose(1, 2)
                .contiguous(), full[:, None, None, :].expand(B, 1, Nq, Nk + M))
    lib_args = [sdpa_args(*a) for a in copies]
    return {
        "ms": time_ms(kernel, copies),
        "plain_ms": time_ms(plain, copies),
        "library_ms": time_ms(
            lambda q, k, v, m: F.scaled_dot_product_attention(
                q, k, v, attn_mask=m, enable_gqa=True), lib_args),
        "bound_ms": b_ms, "bound_by": b_by}


def phase_exchange_kernels() -> dict:
    """Both exchange kernels at the ViT-B/16 shapes of the 2-rank PRISM
    forward (per rank: K/V [8, 100, 12, 64] bf16, L = 20, means
    [8, 2·20, 12, 64]) and at harder ones."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    np_ = 200 // VIT_P
    out = {}
    main = seg_case(VIT_B, np_, (12, 64), VIT_L, bf16, seed=10)
    err = check_seg("ViT bf16 [8, 100, 12·64] L=20 masked, empty segment",
                    main)
    out["segment_means"] = dict(time_seg(main), max_abs_err=err)
    for label, case in (
            ("ViT bf16 unmasked", seg_case(VIT_B, np_, (12, 64), VIT_L,
                                           bf16, seed=11, masked=False)),
            ("ViT f32 masked", seg_case(VIT_B, np_, (12, 64), VIT_L, f32,
                                        seed=12)),
            ("GQA bf16 [4, 512, 8·64] L=16", seg_case(4, 512, (8, 64), 16,
                                                      bf16, seed=13,
                                                      masked=False)),
            ("f32 [4, 256, 8·128] L=16 masked",
             seg_case(4, 256, (8, 128), 16, f32, seed=14))):
        check_seg(label, case)
    t = out["segment_means"]
    print(f"[kernel] segment_means ViT main shape: kernel {t['ms']*1e3:.2f}"
          f" us, bound {t['bound_ms']*1e3:.2f} us ({t['bound_by']}), plain "
          f"{t['plain_ms']*1e3:.2f} us, mean() yardstick "
          f"{t['library_ms']*1e3:.2f} us", flush=True)

    main = prism_case(VIT_B, np_, 12, 12, 64, VIT_P, VIT_L, bf16, seed=20)
    err = check_prism("ViT bf16 q/K/V [8, 100, 12, 64], means [8, 40, 12, "
                      "64], masked, empty segment", main)
    out["prism_attention"] = dict(time_prism(main), max_abs_err=err)
    for label, case in (
            ("ViT f32", prism_case(VIT_B, np_, 12, 12, 64, VIT_P, VIT_L, f32,
                                   seed=21, part=1)),
            ("causal GQA 32/8 dh 64 bf16 Np=512 P=4 L=16 part 2",
             prism_case(2, 512, 32, 8, 64, 4, 16, bf16, seed=22, causal=True,
                        part=2, masked=False)),
            ("causal GQA 32/8 f32 softcap 50 part 3",
             prism_case(2, 512, 32, 8, 64, 4, 16, f32, seed=23, causal=True,
                        part=3, masked=False, softcap=50.0)),
            ("dh 128 GQA 16/4 bf16 Np=256 P=2 L=8 masked",
             prism_case(2, 256, 16, 4, 128, 2, 8, bf16, seed=24, part=1)),
            ("f32 row 0 fully masked (uniform weights)",
             prism_case(4, 100, 12, 12, 64, 2, 20, f32, seed=25,
                        dead_row=True)),
            ("bf16 row 0 fully masked",
             prism_case(4, 100, 12, 12, 64, 2, 20, bf16, seed=26,
                        dead_row=True))):
        check_prism(label, case)
    t = out["prism_attention"]
    print(f"[kernel] prism_attention ViT main shape: kernel "
          f"{t['ms']*1e3:.2f} us, bound {t['bound_ms']*1e3:.2f} us "
          f"({t['bound_by']}), plain {t['plain_ms']*1e3:.2f} us, sdpa "
          f"yardstick {t['library_ms']*1e3:.2f} us", flush=True)
    return out


# ---------------------------------------------------------------------------
# phases 4 and 6: ViT across 2 ranks on the card
# ---------------------------------------------------------------------------

def _on(tree, device):
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on(v, device) for v in tree]
    return tree.to(device)


def _exact_fp32() -> None:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False     # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False


def _small_vit():
    """(cfg, CPU params from seed 0, images) of the small f32 ViT."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticImageDataset
    from repro_torch.models import registry
    cfg = get_config(VIT).reduced(**SMALL_VIT)
    params = registry.init_params(cfg, seed=0, device="cpu")
    images, _ = SyntheticImageDataset(batch_size=2, seed=1).sample()
    return cfg, params, images


def _small_vit_rank(rank, world):
    """One rank of the small f32 ViT on the card: Voltage and PRISM
    logits."""
    import torch
    from repro_torch.api import ExecutionPlan, InferenceSession
    _exact_fp32()
    cfg, params, images = _small_vit()
    session = InferenceSession.from_config(
        VIT, reduced=SMALL_VIT, params=_on(params, "cuda"), device="cuda",
        plans=[ExecutionPlan.voltage(seq_shards=world),
               ExecutionPlan.prism(L=SMALL_L, cr=1.0, seq_shards=world)])
    batch = {"images": torch.from_numpy(images)}
    return {key: session.run(key, batch).cpu().numpy()
            for key in session.plans}


def _prism_oracle(q, k, v, cfg, *, causal=False, window=None,
                  logit_softcap=None, scale=None, kv_mask=None):
    """The per-rank body of the PRISM exchange, composed partition by
    partition on unpartitioned tensors from the port's plain functions."""
    import torch
    from repro_torch.core.prism_attention import prism_attention
    from repro_torch.core.segment_means import segment_means_masked
    P, L = cfg.seq_shards, cfg.L
    qs, ks, vs, ms = (t.chunk(P, dim=1) for t in (q, k, v, kv_mask))
    kc = [segment_means_masked(ks[p], L, ms[p], axis=1) for p in range(P)]
    vc = [segment_means_masked(vs[p], L, ms[p], axis=1) for p in range(P)]
    km = torch.stack([m for m, _ in kc], dim=1)
    vm = torch.stack([m for m, _ in vc], dim=1)
    counts = torch.stack([c for _, c in kc], dim=1)
    seg = qs[0].shape[1] // L
    return torch.cat([prism_attention(qs[p], ks[p], vs[p], km, vm, p, seg,
                                      causal=causal,
                                      logit_softcap=logit_softcap,
                                      scale=scale, kv_mask=ms[p],
                                      mean_counts=counts)
                      for p in range(P)], dim=1)


def phase_small_vit_reference() -> None:
    """The small f32 ViT across 2 ranks on the card (segment-means and
    PRISM-attention kernels, gloo exchange) against one CPU process:
    Voltage against plain local attention, PRISM against the composed
    oracle.  Max abs logit difference ≤ 1e-4."""
    import torch
    from repro_torch.api.strategies import (ExchangeStrategy,
                                            list_strategies,
                                            register_strategy)
    from repro_torch.core.exchange import ExchangeConfig, ExchangeMode
    from repro_torch.core.seq_group import spawn
    from repro_torch.models.vit import forward_vit
    if "prism_oracle" not in list_strategies():
        @register_strategy
        class PrismOracle(ExchangeStrategy):      # this process only
            name = "prism_oracle"
            exchange_mode = ExchangeMode.PRISM_SIM
            distributed = True

            def _prefill(self, q, k, v, cfg, **kw):
                return _prism_oracle(q, k, v, cfg, **kw)
    cfg, params, images = _small_vit()
    imgs = torch.from_numpy(images)
    with torch.inference_mode():
        want = {"voltage": forward_vit(params, imgs, cfg, ExchangeConfig()),
                "prism@1": forward_vit(params, imgs, cfg, ExchangeConfig(
                    ExchangeMode.PRISM_SIM, seq_axis="seq", seq_shards=VIT_P,
                    L=SMALL_L, strategy="prism_oracle"))}
    t0 = time.perf_counter()
    ranks = spawn(_small_vit_rank, VIT_P, timeout=RANK_TIMEOUT_S)
    worst = {}
    for key, w in want.items():
        worst[key] = max(float(abs(r[key] - w.numpy()).max()) for r in ranks)
        if not worst[key] <= 1e-4:
            raise AssertionError(f"small f32 ViT {key}: 2 ranks on the card "
                                 f"vs one CPU process differ by "
                                 f"{worst[key]:.3e} > 1e-4")
    gap = float(abs(want["voltage"] - want["prism@1"]).max())
    print(f"[reference] reduced f32 ViT (2 layers, d 256, dh 64): 2 ranks on"
          f" the card vs one CPU process, max |logit diff| voltage "
          f"{worst['voltage']:.2e}, prism(L={SMALL_L}) {worst['prism@1']:.2e}"
          f" (tol 1e-4; prism vs local differ by {gap:.2e}); "
          f"{time.perf_counter() - t0:.1f} s with rank start-up", flush=True)


def _vit_rank(rank, world):
    """One rank of ViT-B/16 at full width on the shared card."""
    import hashlib
    import numpy as np
    import torch
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.core.seq_group import get_seq_group
    from repro_torch.data import SyntheticImageDataset
    from repro_torch.kernels.prism_attention import prism_attention
    from repro_torch.kernels.segment_means import segment_means
    from repro_torch.transport import exchange_wire_bytes
    group = get_seq_group("seq")
    t0 = time.perf_counter()
    session = InferenceSession.from_config(
        VIT, reduced=False, device="cuda", seed=0,
        plans=[ExecutionPlan.local(),
               ExecutionPlan.voltage(seq_shards=world),
               ExecutionPlan.prism(L=VIT_L, cr=VIT_CR, seq_shards=world)])
    cfg = session.cfg
    digest = hashlib.sha256()
    for leaf in _leaves(session.params):
        digest.update(leaf.float().cpu().numpy().tobytes())
    mine = digest.hexdigest()
    if group.broadcast_object(mine) != mine:
        raise AssertionError(f"rank {rank}: weights differ from rank 0's")
    build_s = time.perf_counter() - t0
    images, _ = SyntheticImageDataset(batch_size=VIT_B).sample()
    batch = {"images": torch.from_numpy(images)}
    keys = list(session.plans)                  # local, voltage, prism@4.95
    for key in keys:                            # warm-up
        session.run(key, batch)
    torch.cuda.synchronize()

    # the main path: one forward per plan, counts read around each
    logits, counts, moved = {}, {}, {}
    kv_width = 2 * cfg.n_kv_heads * cfg.hd      # K and V per token
    for key in keys:
        segment_means.launches = prism_attention.launches = 0
        group.reset_stats()
        logits[key] = session.run(key, batch)
        torch.cuda.synchronize()
        counts[key] = (segment_means.launches, prism_attention.launches)
        moved[key] = group.stats.payload_bytes
        plan = session.plans[key]
        want_bytes = 0 if not plan.distributed else exchange_wire_bytes(
            plan.effective_codec, n_tokens=VIT_TOKENS, d_model=kv_width,
            bytes_per_el=cfg.torch_dtype.itemsize, batch=VIT_B, P=world,
            n_layers=cfg.n_layers, L=plan.L)
        if moved[key] != want_bytes:
            raise AssertionError(f"rank {rank} {key}: gathered "
                                 f"{moved[key]} payload bytes, transport "
                                 f"accounting says {want_bytes}")
        want = ((2 * cfg.n_layers, cfg.n_layers) if plan.mode == "prism"
                else (0, 0))
        if counts[key] != want:
            raise AssertionError(f"rank {rank} {key}: (segment_means, "
                                 f"prism_attention) launches {counts[key]}, "
                                 f"want {want}")
    local, volt, prism = (logits[k] for k in keys)
    for key, lg in logits.items():
        if lg.shape != (VIT_B, cfg.vocab_size) or not torch.isfinite(
                lg).all():
            raise AssertionError(f"rank {rank} {key}: logits "
                                 f"{tuple(lg.shape)} not finite / wrong")
    volt_err = (volt - local).abs().max().item() / local.abs().max().item()
    if not volt_err <= 5e-2:
        raise AssertionError(f"rank {rank}: voltage vs local logits differ by"
                             f" {volt_err:.3e} of the largest logit > 5e-2")
    both = group.all_gather(prism, meta=True)
    if not torch.equal(both[0], both[1]):
        raise AssertionError("prism logits differ between the ranks")
    agree = (prism.argmax(-1) == local.argmax(-1)).float().mean().item()

    # forward wall time and its staged-collective part, both ranks at once
    times = {}
    for key in keys:
        walls, coll = [], []
        for _ in range(12):
            group.reset_stats()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            session.run(key, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
            coll.append(group.stats.seconds * 1e3)
        times[key] = (statistics.median(walls), statistics.median(coll),
                      group.stats.calls)

    session.profile(backend="simulated")
    session.dispatch(batch)
    rec = session.history[-1]
    picked = group.all_gather(torch.tensor(keys.index(rec.exec_key)),
                              meta=True)
    if len(set(picked.tolist())) != 1:
        raise AssertionError(f"dispatch ran {picked.tolist()} on the ranks")
    return dict(counts=counts, moved=moved, volt_err=volt_err, agree=agree,
                times=times, keys=keys, build_s=build_s,
                dispatch=(rec.exec_key, rec.wall_ms, rec.wire_bytes),
                logits=np.asarray(prism.cpu()), cfg=(cfg.n_layers,
                                                     cfg.d_model,
                                                     cfg.n_heads, cfg.hd))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def phase_vit(card: str) -> dict:
    """ViT-B/16 at full width across 2 ranks on the one card → launch
    totals of the main-path forwards, summed over the ranks."""
    from repro_torch.core.seq_group import spawn
    t0 = time.perf_counter()
    ranks = spawn(_vit_rank, VIT_P, timeout=RANK_TIMEOUT_S)
    r0 = ranks[0]
    L_, d, H, hd = r0["cfg"]
    print(f"[vit] {VIT} full width ({L_} layers, d {d}, {H} heads, dh {hd},"
          f" bf16, random weights from seed 0, checksum equal on both ranks)"
          f" on {VIT_P} ranks sharing the card, gloo staged through host "
          f"memory; {time.perf_counter() - t0:.1f} s with rank start-up",
          flush=True)
    for key in r0["keys"]:
        sm, pa = r0["counts"][key]
        wall, coll, calls = r0["times"][key]
        other = ranks[1]["times"][key]
        print(f"[vit] {key}: B={VIT_B} images, per rank per forward: "
              f"segment_means {sm}, prism_attention {pa} launches; gathered "
              f"{r0['moved'][key] / 1e6:.3f} MB (= transport accounting); "
              f"forward {wall:.2f} ms (rank 1: {other[0]:.2f} ms), staged "
              f"collectives {coll:.2f} ms of it in {calls} calls (median of "
              f"12; both ranks share one card) [{card}]", flush=True)
    key, wall, wire = r0["dispatch"]
    print(f"[vit] voltage vs local: max |logit diff| {r0['volt_err']:.2e} "
          f"of the largest logit (tol 5e-2); prism logits finite and equal "
          f"on both ranks; local vs prism argmax agreement "
          f"{r0['agree']:.0%} over {VIT_B} images; dispatch picked "
          f"{key!r} on both ranks ({wall:.1f} ms, {wire / 1e6:.3f} MB "
          f"modeled on the wire)", flush=True)
    prism = next(k for k in r0["keys"] if k.startswith("prism"))
    return {name: sum(r["counts"][prism][i] for r in ranks)
            for i, name in enumerate(("segment_means", "prism_attention"))}


def phase_build() -> None:
    """Every kernel of the main paths, built together (one ``nvcc`` per
    source; ``flash_decode.cu`` holds the dense and the paged entry
    points)."""
    from repro_torch.kernels.flash_decode.kernel import LIBRARY as fd
    from repro_torch.kernels.prism_attention.kernel import LIBRARY as pa
    from repro_torch.kernels.segment_means.kernel import LIBRARY as sm
    libs = (fd, sm, pa)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs))
    for lib in libs:
        ptxas = [ln.strip() for ln in lib.info["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[build] {lib.source.name} → {Path(lib.info['path']).name} in "
              f"{lib.info['seconds']:.1f} s; ptxas: " + " | ".join(ptxas),
              flush=True)
    print(f"[build] all {len(libs)} sources (4 kernels) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA "
             "card")
    _exact_fp32()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = nvidia_smi()
    print(f"[device] {name}, {count} device(s); nvidia-smi: {card}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    phase_build()
    timed = phase_kernels()
    paged = phase_paged_kernel()
    exchange = phase_exchange_kernels()
    phase_small_reference()
    phase_small_serving()
    phase_small_vit_reference()
    launches, session = phase_session(card)
    serve_dense, serve_paged = phase_serve(card, session)
    del session
    torch.cuda.empty_cache()
    vit_launches = phase_vit(card)

    main_shape = timed[(PROMPT_B, PROMPT_T + N_NEW)]
    src = "src/repro_torch/kernels/{0}/csrc/{1}.cu"
    rows = (("flash_decode", "src/repro/kernels/flash_decode/kernel.py:61",
             launches + serve_dense, main_shape),
            ("flash_decode_paged",
             "src/repro/kernels/flash_decode/paged.py:58", serve_paged,
             paged),
            ("segment_means", "src/repro/kernels/segment_means/kernel.py:25",
             vit_launches["segment_means"], exchange["segment_means"]),
            ("prism_attention",
             "src/repro/kernels/prism_attention/kernel.py:68",
             vit_launches["prism_attention"], exchange["prism_attention"]))
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [{"name": kname, "route": "cuda",
                "source": src.format(*[kname.replace("_paged", "")] * 2),
                "replaces": replaces, "launches": n,
                **{k: t[k] for k in keys}}
               for kname, replaces, n, t in rows]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


if __name__ == "__main__":
    main()
