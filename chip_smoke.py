#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py

Phases, one line each (more for the kernel table):

1. device  — the card's name, the device count and ``nvidia-smi``'s name and
             power limit; fails without a CUDA card.
2. build   — builds every kernel of the main path from the sources in the
             checkout (``nvcc``, one process per source, started together).
3. kernels — calls each kernel's wrapper on tensors on the card and holds
             it against its plain PyTorch version on the same inputs
             (f32 inputs: relative max error ≤ 1e-5; bf16: ≤ 1e-3), at the
             main path's shapes and a few harder ones, and times kernel,
             plain version and a one-call PyTorch yardstick with CUDA events
             (warm-up, then the median of many launches on inputs cold in
             L2).
4. session — the main path at the full width of llama3.2-1b:
             ``InferenceSession`` profile → decide → dispatch → greedy
             generate under the ``local`` and ``prism_sim`` plans, with the
             kernel launch counts read around each generate, and the kernel
             time of one ``local`` generate from ``torch.profiler``; before
             it, a small f32 model whose decode logits on the card are held
             against the same model on the CPU.

The line before the last is a JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero and prints no result.
"""
from __future__ import annotations

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


def bound(case) -> tuple:
    """Least time the card needs: bytes (each input read once, each output
    written once) over HBM rate vs flops over the inputs' peak rate."""
    q, k, v, bias = case["q"], case["k"], case["v"], case["bias"]
    B, H, dh = q.shape
    S = k.shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, bias))
    nbytes += (B * H * dh + 2 * B * H) * 4               # o, m, l in f32
    flops = 4 * B * H * S * dh                           # q·k and p·v
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_case(case) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
    args = (case["q"], case["k"], case["v"], case["bias"])
    sc = case["softcap"]
    nbytes = sum(t.numel() * t.element_size() for t in args)
    copies = [args] + [tuple(t.clone() for t in args)
                       for _ in range(min(255, int(2 * L2_BYTES // nbytes)))]
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
    return total


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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA "
             "card")
    torch.backends.cuda.matmul.allow_tf32 = False     # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = nvidia_smi()
    print(f"[device] {name}, {count} device(s); nvidia-smi: {card}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    from repro_torch.kernels.flash_decode import kernel as fd_kernel
    t0 = time.perf_counter()
    fd_kernel.build()
    ptxas = [ln.strip() for ln in fd_kernel.BUILD_INFO["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[build] flash_decode.cu → {Path(fd_kernel.BUILD_INFO['path']).name}"
          f" in {time.perf_counter() - t0:.1f} s; ptxas: "
          + " | ".join(ptxas), flush=True)

    timed = phase_kernels()
    phase_small_reference()
    launches = phase_session(card)

    main_shape = timed[(PROMPT_B, PROMPT_T + N_NEW)]
    kernels = [{
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode/kernel.py:61",
        "launches": launches, "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"]}]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


if __name__ == "__main__":
    main()
