#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py

Phases, one line each (more for the kernel table):

1. device    — the card's name, the device count and ``nvidia-smi``'s name
               and power limit; fails without a CUDA card.
2. build     — builds every kernel of the main paths from the sources in
               the checkout (``nvcc``, one process per source, started
               together), before any rank is spawned, and prints every
               instantiation's registers, spills, shared memory per CTA
               and CTAs per SM (flash-decode, segment means, PRISM
               attention).
3. kernels   — calls each kernel's wrapper on tensors on the card and
               holds it against its plain PyTorch version on the same
               inputs (f32 inputs: relative max error ≤ 1e-5; bf16:
               ≤ 1e-3), at the main paths' shapes and a few harder ones,
               and times kernel, plain version and a one-call PyTorch
               yardstick with CUDA events (warm-up, then the median of many
               launches on inputs cold in L2).  Flash-decode cases span
               splits of S from 1 to 8 (B 1 at S 1, 63, 65, 2047, 8192;
               windows, softcap, dh 128, f32), and timed at the decode
               shapes of internlm2-1.8b (16/8 heads) and qwen1.5-32b (40/40
               heads, 160 CTAs) and gemma2-27b (32/16 heads, softcap 50,
               scale 1/12; and B 1 at S 4624 under its window of 4096) at
               dh 128; fully masked rows must give m = -1e30, l = S and
               the plain version's o; each timed shape prints its splits.
   The shard partial (``dispatch.decode_partials``, the sharded decode's
               route onto flash-decode) is held with a nonzero offset, on
               a block with no valid position (m = -1e30, l = Sp) and in
               f32 with a softcap; every block's partials merged as the
               ranks merge them match the dense kernel on the whole cache;
               timed at the ``lm`` phase's decode shape; gemma2's
               windowed shard partial likewise (a block wholly outside
               the window gives m = -1e30, l = Sp; the blocks merged
               against the dense windowed kernel), timed at the ``gemma``
               phase's decode shape.
   The paged flash-decode kernel is held likewise at the paged pool's
               shape and harder ones (page sizes 8 and 5, dh 128, f32,
               softcap, shuffled and shared pages, trash entries, rows of
               length 1 and full length, fully masked rows), and timed
               beside a two-call yardstick and the dense kernel on the
               gathered cache.
   Segment means is held one input at a time and for K and V in one
               launch (masked with an empty segment, unmasked, f32, an odd
               feature width) and the K+V call timed at the ViT exchange's
               shape beside a ``mean()`` over K and V stacked; PRISM
               attention is held with the means as the exchange's gather
               leaves them (partition 0 and 1), flat, causal with future
               tiles skipped, dh 128, f32 and fully masked rows, and timed
               at the ViT shape with its row plan and with 2 CTAs per
               (batch row, KV head); both again at the ``lm`` phase's
               ``prism`` shape (K+V [4, 256, 8·64] L 16; causal GQA 32/8,
               parts 0 and 1), timed there, and at the ``gemma`` phase's
               (K+V [1, 2048, 16·128] L 16; q [1, 2048, 32, 128], 16 KV
               heads, causal, softcap 50, scale 1/12, parts 0 and 3 of 4).
4. reference — small f32 models on the card against the same weights on
               the CPU: a llama decoded 12 steps; the same llama served by
               ``ServingRuntime`` in dense and paged mode with full and
               partial prefix hits; a ViT whose Voltage and PRISM
               forwards run across 2 ranks on the card, held against one
               CPU process that composes the PRISM exchange partition by
               partition from the plain functions; and the small llama
               across 2 ranks on the card (``voltage`` and ``prism``
               forwards, 12 sharded decode steps: ≤ 1e-4 against ``local``
               and ``prism_sim`` on the CPU; greedy tokens exact); a small
               f32 gemma2 (window 16, int8 KV) decoded 32 steps, each from
               the CPU's cache, greedy tokens exact, and across 4 ranks on
               the card against 4 CPU ranks under ``voltage`` and
               ``prism(L=2)`` at N 64 (the halo) and N 16 (the Voltage
               gather), the halo's bytes asserted.
5. session   — llama3.2-1b at full width: ``InferenceSession`` profile
               (``measured`` on the H100 presets, batches 1-32, the curve
               ``H100_SXM`` is fitted to, with the card's power draw
               sampled; the simulated Jetson decision printed beside each
               measured one) → decide → dispatch → greedy generate under
               ``local`` and ``prism_sim``, flash-decode launch counts read
               around each generate, and the kernel time of one ``local``
               generate from ``torch.profiler``.  ``[fit]`` prints the
               constants this run gives beside the preset's.
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
               the forward wall time with its staged-collective part;
               ``[fit]`` prints the staged link's constants this run gives.
8. lm        — llama3.2-1b at full width across 2 ranks on the one card:
               ``forward_lm(last_only)`` at B 4, N 512 under ``local``,
               ``voltage`` and ``prism(L=16)`` (segment-means and PRISM-
               attention launches, 16 each a ``prism`` forward, and the
               gathered bytes asserted; wall time and its staged part);
               greedy ``generate`` of [4, 32] + 16 tokens under
               ``local``, ``voltage`` and ``prism(L=4)`` on the sharded
               cache (flash-decode launches, 16 a step, one staged merge a
               layer and the same tokens on both ranks asserted; prefill
               seconds, decode ms a step, merge bytes, agreement with
               ``local``); one ``dispatch`` of a ``prism`` plan.
9. archs     — internlm2-1.8b, qwen1.5-32b and gemma2-27b at full width
               (each with all its layers where they fit beside nothing
               else, else fewer, whole local/global pairs for gemma2, as
               its lines say): the measured profile on the H100 presets at
               B 1, 8 and 32 with the anchor scale, decide and explain, and
               greedy generate under ``local`` with flash-decode launches
               asserted, decode time, device idle share and peak memory;
               gemma2 (no ``prism_sim`` plan: it raises on windowed layers,
               as in the JAX package) a second time at B 1 from a
               4608-token prompt, so its window masks every decode step.
10. codec    — the codecs' decode throughput measured on the card
               (``calibrate_codec_bws``) beside the modeled class
               constants; then 2 ranks sharing the card: ViT-B/16 B 8
               under ``prism`` with ``int8``, ``int4`` and ``topk(8)`` (the
               codec exchange) and ``voltage`` through the ring executor
               (``overlap_chunks`` 1 and 3), llama3.2-1b
               ``forward_lm(last_only)`` B 4 N 512 under ``prism`` + int8
               and the ring (1 and 2), each with forward ms, staged ms and
               share, calls, and the payload and meta bytes received per
               rank (payload asserted equal to the codec accounting); each
               ViT codec's argmax agreement with ``local`` and, on a small
               f32 ViT, its logits on the card against the CPU (≤ 1e-4);
               each ring forward again with the card synchronised before
               every ring wait (what the overlap hides); one staged
               transfer alone (``all_gather`` and ``ring_shift``) at each
               codec's bytes; greedy ``generate`` [4, 32] + 16 under the
               ring (flash-decode launches asserted, the same tokens on
               both ranks).
11. gemma    — gemma2-27b at full width cut to one local/global pair
               (4 ranks × 54.5 GB would not share 80 GB) across 4 ranks on
               the card: ``forward_lm(last_only)`` at B 1, N 8192 under
               ``local``, ``voltage`` and ``prism(L=16)`` (Np 2048, so the
               windowed layer exchanges its halo of 2 partitions), per
               rank the forward ms, staged ms and share, calls and bytes
               received by kind (halo and Voltage payload, launches
               asserted); greedy ``generate`` of the prompt + 8 under
               ``voltage`` (the windowed sharded decode; flash-decode
               launches asserted, the same tokens on every rank) and its
               agreement with a one-rank ``local`` run.

12. profile-seq — ViT-B/16 at full width on 2 ranks sharing the card:
               ``profile(backend="measured")`` on the H100 presets under
               ``local``, ``voltage`` and ``prism(L=20)`` at B 1, 4 and 8,
               SPMD on both ranks (partitioned plans charged per rank,
               their measured staged seconds taken out of the compute):
               the same map and decisions at B 1 and 8 on both ranks,
               segment-means and PRISM-attention launches counted in the
               ``prism`` timing, and per plan and batch the charged
               rank's forward (the rank with the most compute), its
               staged ms and calls, the compute charged and the modeled
               staging at each swept bandwidth.
13. fleet    — two ``WorkerHandle``s of llama3.2-1b at full width (bf16,
               one seed, 4 slots each) behind a ``FleetRouter``: 24
               requests fanned out, one worker failed after the first
               step, every completion held against the survivor's B 1
               generate (token-exact, or diverging only where the B 1
               logits are within ``FLEET_TIE_TOL`` of a tie), flash-decode
               launches counted; then two ``repro_torch.rpc.worker``
               subprocesses (``--full --device cuda``, 4 slots) with their
               codec decode measured on the card, a load under a
               kill/revive schedule (SIGKILL and respawn) that must
               reroute and readmit, every request served once and held
               as above against an in-process session from the same
               seed, and both workers closed at shutdown.

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
LM_P, LM_B, LM_N, LM_L, GEN_L = 2, 4, 512, 16, 4   # the lm phase
GEMMA = "gemma2-27b"
GEMMA_P, GEMMA_N, GEMMA_L, GEMMA_NEW = 4, 8192, 16, 8   # the gemma phase
GEMMA_LONG = 4608           # [arch]'s B 1 prompt: its window masks each step
SMALL_GEMMA = dict(dtype="float32", head_dim=64, n_heads=8, n_kv_heads=4,
                   d_model=256)
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

def decode_case(B, S, dh, dtype, *, seed, heads=(N_HEADS, N_KV), window=None,
                softcap=None, masked_row=False, lens=None, scale=None):
    """Random q, K and V with ``heads`` = (query heads, KV heads), random
    lengths in 1..S per row (or ``lens``), and their validity bias;
    ``scale`` None is dh^-0.5."""
    import torch
    from repro_torch.kernels.flash_decode import validity_bias
    g = torch.Generator(device="cuda").manual_seed(seed)
    H, Hk = heads

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)
    q, k, v = randn(B, H, dh), randn(B, S, Hk, dh), randn(B, S, Hk, dh)
    clen = torch.randint(1, S + 1, (B,), generator=g, device="cuda")
    if lens is not None:
        clen = torch.tensor(lens, device="cuda")
    if masked_row:
        clen[0] = 0
    bias = validity_bias(B, S, clen, window=window, device="cuda")
    return dict(q=q, k=k, v=v, bias=bias, softcap=softcap, scale=scale)


def check_case(case, got=None) -> dict:
    """Kernel vs plain version on one case → errors; raises past tolerance.
    ``got``: the kernel's partials from another route (default: a direct
    ``flash_decode`` call on the case's bias)."""
    import torch
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
    args = (case["q"], case["k"], case["v"], case["bias"])
    kw = dict(softcap=case["softcap"], scale=case["scale"])
    if got is None:
        got = flash_decode(*args, **kw)
    torch.cuda.synchronize()
    want = flash_decode_ref(*args, **kw)
    tol = 1e-5 if case["q"].dtype == torch.float32 else 1e-3
    live = (case["bias"] == 0).any(dim=1)            # rows with a valid slot
    o_g = got[0] / got[2][..., None]
    o_w = want[0] / want[2][..., None]
    errs = {}
    checked = (("o/l", o_g, o_w), ("m", got[1], want[1]),
               ("l", got[2], want[2])) if live.any() else ()
    for name, a, b in checked:
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
        errs["masked o"] = rel_err(got[0][~live], want[0][~live])
        if not errs["masked o"] <= tol:
            raise AssertionError(f"flash_decode fully masked row: o = sum v"
                                 f" off by {errs['masked o']:.3e} > {tol:g}")
    errs["max_abs_err"] = ((o_g[live] - o_w[live]).abs().max().item()
                           if live.any() else 0.0)
    return errs


def splits_of(q, Hk, S) -> int:
    """The kernel's CTAs along S for these inputs (``split_plan``); the
    launch holds B·Hk·splits CTAs."""
    from repro_torch.kernels.flash_decode.kernel import plan_for
    return plan_for(q.device, q.dtype, q.shape[0], Hk, S, q.shape[2])


def err_text(errs) -> str:
    return " ".join(f"{k} {v:.2e}" for k, v in errs.items()
                    if k != "max_abs_err")


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
    """Flash-decode: q, the bias and the K and V rows of the positions that
    count in, o, m, l out; 4·H·dh flops per such position (q·k and p·v).
    A masked position of a row with a valid one adds exactly 0, so only
    the valid positions count; a fully masked row needs all S."""
    q, k, bias = case["q"], case["k"], case["bias"]
    B, H, dh = q.shape
    S, Hk = k.shape[1], k.shape[2]
    valid = (bias > -1e30).sum(dim=1)
    positions = int(valid.masked_fill(valid == 0, S).sum())
    moved = (nbytes(q, bias) + 2 * positions * Hk * dh * k.element_size()
             + (B * H * dh + 2 * B * H) * 4)
    return roofline(moved, 4 * H * dh * positions, q.dtype)


def time_case(case) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
    args = (case["q"], case["k"], case["v"], case["bias"])
    kw = dict(softcap=case["softcap"], scale=case["scale"])
    copies = cold_copies(args)
    # yardstick only: one PyTorch call over the same cache (the port never
    # calls it), in its own [B, heads, S, dh] layout made outside the timing
    sdpa_args = [(q[:, :, None, :], k.transpose(1, 2).contiguous(),
                  v.transpose(1, 2).contiguous(), (b == 0)[:, None, None, :])
                 for q, k, v, b in copies]
    b_ms, b_by = bound(case)
    whole = dict(case, bias=torch.zeros_like(case["bias"]))
    return {
        "full_bound_ms": bound(whole)[0],
        "ms": time_ms(lambda *a: flash_decode(*a, **kw), copies),
        "plain_ms": time_ms(lambda *a: flash_decode_ref(*a, **kw), copies),
        "library_ms": time_ms(
            lambda q, k, v, mask: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True,
                scale=case["scale"]), sdpa_args),
        "bound_ms": b_ms, "bound_by": b_by}


# the decode shapes of the dense archs beside llama3.2-1b: (arch, query
# heads, KV heads), dh 128, every row's cache full at S, each arch's
# softcap and query scale
DECODE_ARCHS = (("internlm2-1.8b", 16, 8), ("qwen1.5-32b", 40, 40),
                (GEMMA, 32, 16))


def report_timed(case, label: str) -> dict:
    """Check, time and print one flash-decode case → its kernels-line
    numbers."""
    errs = check_case(case)
    t = time_case(case)
    B, H, dh = case["q"].shape
    S, Hk = case["k"].shape[1], case["k"].shape[2]
    splits = splits_of(case["q"], Hk, S)
    cap = case["softcap"]
    extra = ("" if cap is None else f" softcap={cap:g}") + (
        "" if case["scale"] is None else f" scale={case['scale']:.6g}")
    print(f"[kernel] flash_decode {label} bf16 B={B} S={S} H={H} Hk={Hk} "
          f"dh={dh}{extra}, splits {splits} ({B * Hk * splits} CTAs): err "
          f"{err_text(errs)} (tol 1e-3) | kernel {t['ms']*1e3:.2f} us, bound "
          f"{t['bound_ms']*1e3:.2f} us ({t['bound_by']}; whole cache "
          f"{t['full_bound_ms']*1e3:.2f} us), plain {t['plain_ms']*1e3:.2f} "
          f"us, sdpa yardstick {t['library_ms']*1e3:.2f} us"
          + ("" if cap is None else " (sdpa computes no softcap)"),
          flush=True)
    return dict(t, max_abs_err=errs["max_abs_err"])


def phase_kernels() -> dict:
    import torch
    from repro_torch.configs import get_config
    bf16, f32 = torch.bfloat16, torch.float32
    timed = {}
    for B, S in ((1, 2048), (8, 2048), (PROMPT_B, PROMPT_T + N_NEW)):
        timed[(B, S)] = report_timed(decode_case(B, S, 64, bf16, seed=B * S),
                                     ARCH)
    for i, (arch, H, Hk) in enumerate(DECODE_ARCHS):
        c = get_config(arch)
        for S in (PROMPT_T + N_NEW, 2048):
            timed[(arch, S)] = report_timed(
                decode_case(PROMPT_B, S, 128, bf16, seed=100 + 10 * i + S,
                            heads=(H, Hk), lens=[S] * PROMPT_B,
                            softcap=c.attn_softcap, scale=c.query_scale),
                arch)
    # gemma2's local layers at [arch]'s B 1 decode: the window masks the
    # first 528 of 4624 positions
    c = get_config(GEMMA)
    S = GEMMA_LONG + N_NEW
    timed[(GEMMA, "window")] = report_timed(
        decode_case(1, S, 128, bf16, seed=150, heads=(32, 16), lens=[S],
                    window=c.window, softcap=c.attn_softcap,
                    scale=c.query_scale),
        f"{GEMMA} local layer, window {c.window} ({S - c.window} of {S} "
        f"positions masked)")
    extra = (
        ("f32 B=8 S=2048", decode_case(8, 2048, 64, f32, seed=1)),
        ("f32 B=4 S=48, row 0 fully masked",
         decode_case(4, 48, 64, f32, seed=2, masked_row=True)),
        ("bf16 B=8 S=2048 window=256 softcap=50",
         decode_case(8, 2048, 64, bf16, seed=3, window=256, softcap=50.0)),
        ("bf16 B=4 S=2048 dh=128", decode_case(4, 2048, 128, bf16, seed=4)),
        ("bf16 B=4 S=48, row 0 fully masked",
         decode_case(4, 48, 64, bf16, seed=5, masked_row=True)),
        ("bf16 B=1 S=1", decode_case(1, 1, 64, bf16, seed=6)),
        ("bf16 B=1 S=63", decode_case(1, 63, 64, bf16, seed=7, lens=[63])),
        ("bf16 B=1 S=65", decode_case(1, 65, 64, bf16, seed=8, lens=[65])),
        ("f32 B=1 S=65 length 1",
         decode_case(1, 65, 64, f32, seed=9, lens=[1])),
        ("bf16 B=1 S=2047", decode_case(1, 2047, 64, bf16, seed=10,
                                        lens=[2047])),
        ("bf16 B=1 S=2047 length 100",
         decode_case(1, 2047, 64, bf16, seed=11, lens=[100])),
        ("bf16 B=1 S=8192", decode_case(1, 8192, 64, bf16, seed=12)),
        ("f32 B=1 S=8192 window=256",
         decode_case(1, 8192, 64, f32, seed=13, window=256, lens=[8000])),
        ("bf16 B=1 S=8192 dh=128 softcap=50",
         decode_case(1, 8192, 128, bf16, seed=14, softcap=50.0)),
        ("f32 B=2 S=2048 dh=128, row 0 fully masked",
         decode_case(2, 2048, 128, f32, seed=15, masked_row=True)),
        ("bf16 B=1 S=2048, the row fully masked",
         decode_case(1, 2048, 64, bf16, seed=16, masked_row=True)),
        ("f32 B=4 S=48 40/40 heads dh=128 (G=1, 160 CTAs)",
         decode_case(4, 48, 128, f32, seed=18, heads=(40, 40))),
        ("bf16 B=4 S=300 40/40 heads dh=128, row 0 fully masked",
         decode_case(4, 300, 128, bf16, seed=19, heads=(40, 40),
                     masked_row=True)),
        ("f32 B=4 S=2048 16/8 heads dh=128 (G=2) softcap=50",
         decode_case(4, 2048, 128, f32, seed=20, heads=(16, 8),
                     softcap=50.0)),
        ("f32 B=4 S=48 32/16 heads dh=128 softcap=50 scale=1/12 (gemma2)",
         decode_case(4, 48, 128, f32, seed=21, heads=(32, 16),
                     softcap=50.0, scale=1 / 12)),
        ("f32 B=1 S=4624 32/16 heads dh=128 window=4096 softcap=50 "
         "scale=1/12 (gemma2)",
         decode_case(1, 4624, 128, f32, seed=22, heads=(32, 16),
                     lens=[4624], window=4096, softcap=50.0, scale=1 / 12)),
    )
    for label, case in extra:
        errs = check_case(case)
        tol = "1e-5" if case["q"].dtype == torch.float32 else "1e-3"
        S, Hk = case["k"].shape[1], case["k"].shape[2]
        print(f"[kernel] flash_decode {label}, splits "
              f"{splits_of(case['q'], Hk, S)}: err {err_text(errs)} "
              f"(tol {tol})", flush=True)
    return timed


# ---------------------------------------------------------------------------
# phase 3: one shard's flash-decode partials (the sharded decode's route)
# ---------------------------------------------------------------------------

def shard_case(B, S, P, rank, dh, dtype, *, seed, lens, heads=(N_HEADS, N_KV),
               softcap=None, window=None, scale=None):
    """Rank ``rank``'s block of a [B, S] cache split P ways (``Sp`` =
    ceil(S / P) positions from global position ``rank·Sp``), a query, the
    global lengths ``lens`` and the block's validity bias (under the
    sliding ``window``, if any)."""
    import torch
    from repro_torch.kernels.flash_decode import validity_bias
    g = torch.Generator(device="cuda").manual_seed(seed)
    H, Hk = heads
    Sp = -(-S // P)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)
    clen = torch.tensor(lens, device="cuda")
    return dict(q=randn(B, H, dh), k=randn(B, Sp, Hk, dh),
                v=randn(B, Sp, Hk, dh), clen=clen, offset=rank * Sp,
                bias=validity_bias(B, Sp, clen, offset=rank * Sp,
                                   window=window, device="cuda"),
                softcap=softcap, window=window, scale=scale)


def shard_partials(case):
    """The route the sharded decode takes: ``dispatch.decode_partials``
    with the block's offset."""
    from repro_torch.kernels import dispatch as kdsp
    return kdsp.decode_partials(case["q"][:, None], case["k"], case["v"],
                                case["clen"], offset=case["offset"],
                                window=case["window"],
                                logit_softcap=case["softcap"],
                                scale=case["scale"])


def check_merge(label, B, S, P, dh, dtype, *, seed, lens, heads=(N_HEADS,
                                                                  N_KV),
                window=None, softcap=None, scale=None):
    """Every block's partials (the kernel through the offset route),
    merged as the ranks merge them, against the dense kernel's
    normalised f32 output on the whole cache (relative max error within
    tolerance), under the same window, softcap and scale."""
    import torch
    from repro_torch.kernels import dispatch as kdsp
    from repro_torch.kernels.flash_decode import merge_partials
    kw = dict(window=window, softcap=softcap, scale=scale)
    blocks = [shard_case(B, S, P, r, dh, dtype, seed=seed, lens=lens,
                         heads=heads, **kw) for r in range(P)]
    q = blocks[0]["q"]
    parts = []
    for c in blocks:
        c["q"] = q                      # one query, every block its own K/V
        parts.append(shard_partials(c))
    got = merge_partials(*(torch.stack(p) for p in zip(*parts)))
    k = torch.cat([c["k"] for c in blocks], dim=1)
    v = torch.cat([c["v"] for c in blocks], dim=1)
    o, m, l = kdsp.decode_partials(q[:, None], k, v, blocks[0]["clen"],
                                   window=window, logit_softcap=softcap,
                                   scale=scale)
    want = o / l[..., None]                  # f32, before any cast
    torch.cuda.synchronize()
    err, tol = rel_err(got, want), _tol(dtype)
    if not err <= tol or not torch.isfinite(got).all():
        raise AssertionError(f"sharded decode merge {label}: relative error "
                             f"{err:.3e} > {tol:g} (or not finite)")
    print(f"[kernel] flash_decode shard partials merged over {P} blocks "
          f"{label}: rel err {err:.2e} vs the dense kernel on the whole "
          f"cache (tol {tol:g})", flush=True)


def phase_shard_partial() -> dict:
    """The shard partial with a nonzero offset, a shard with no valid
    position (m = -1e30, l = Sp), f32 with a softcap, and the merge;
    timed at the 2-rank llama3.2-1b decode shape (B 4, S 48: Sp 24, the
    second rank's block, 16 of its 24 positions valid)."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    S, P = PROMPT_T + N_NEW, LM_P
    main = shard_case(PROMPT_B, S, P, 1, 64, bf16, seed=40, lens=[40] * 4)
    for label, case in (
            ("rank 1 of 2, B 4 S 48 (Sp 24, offset 24), lengths 30 48 25 40",
             shard_case(4, S, P, 1, 64, bf16, seed=41, lens=[30, 48, 25, 40])),
            ("rank 1 of 2, no valid position (lengths 24 10 1 5)",
             shard_case(4, S, P, 1, 64, bf16, seed=42, lens=[24, 10, 1, 5])),
            ("f32 rank 2 of 4, S 50 (Sp 13, offset 26), 16/8 heads dh 128, "
             "softcap 50, lengths 27 30 40 50",
             shard_case(4, 50, 4, 2, 128, f32, seed=43,
                        lens=[27, 30, 40, 50], heads=(16, 8), softcap=50.0)),
            ("f32 rank 3 of 4, no valid position",
             shard_case(2, 50, 4, 3, 64, f32, seed=44, lens=[39, 1]))):
        errs = check_case(case, got=shard_partials(case))
        print(f"[kernel] flash_decode shard partial {label}: err "
              f"{err_text(errs)} (tol {_tol(case['q'].dtype):g})",
              flush=True)
    check_merge("bf16 B 4 S 48 P 2, lengths 10 30 48 24", 4, S, P, 64, bf16,
                seed=45, lens=[10, 30, 48, 24])
    check_merge("f32 B 4 S 50 P 4, lengths 1 14 27 50", 4, 50, 4, 64, f32,
                seed=46, lens=[1, 14, 27, 50])
    errs = check_case(main, got=shard_partials(main))
    t = dict(time_case(main), max_abs_err=errs["max_abs_err"])
    print(f"[kernel] flash_decode shard partial, the lm phase's decode shape"
          f" (rank 1 of 2: B 4, Sp 24 of S 48, offset 24, 16 valid, bf16, "
          f"{N_HEADS}/{N_KV} heads, dh 64, 1 split): kernel "
          f"{t['ms']*1e3:.2f} us, bound {t['bound_ms']*1e3:.2f} us "
          f"({t['bound_by']}), plain {t['plain_ms']*1e3:.2f} us, sdpa "
          f"yardstick over the block {t['library_ms']*1e3:.2f} us", flush=True)
    return t


def phase_gemma_shard_partial() -> dict:
    """gemma2's windowed sharded decode: the shard partial with offset and
    window (a block wholly outside the window gives m = -1e30, l = Sp),
    every block merged against the dense windowed kernel, and timed at the
    gemma phase's first decode step (B 1, S 8200 over 4 ranks: Sp 2050,
    length 8193, window 4096; rank 2's block, every position valid)."""
    import torch
    from repro_torch.configs import get_config
    bf16, f32 = torch.bfloat16, torch.float32
    c = get_config(GEMMA)
    g = dict(heads=(c.n_heads, c.n_kv_heads), softcap=c.attn_softcap,
             scale=c.query_scale)
    S, P, clen = GEMMA_N + GEMMA_NEW, GEMMA_P, GEMMA_N + 1
    for label, case in (
            (f"rank 0 of 4, B 1 S {S} (Sp {S // P}), length {clen}, window "
             f"{c.window}: no position in the window",
             shard_case(1, S, P, 0, 128, bf16, seed=60, lens=[clen],
                        window=c.window, **g)),
            ("rank 1 of 4: 3 positions in the window",
             shard_case(1, S, P, 1, 128, bf16, seed=61, lens=[clen],
                        window=c.window, **g)),
            ("f32 rank 0 of 4, B 2 S 64, window 20, lengths 64 40: no "
             "position in the window",
             shard_case(2, 64, 4, 0, 128, f32, seed=62, lens=[64, 40],
                        window=20, **g)),
            ("f32 rank 2 of 4, B 2 S 64, window 20, lengths 64 40",
             shard_case(2, 64, 4, 2, 128, f32, seed=63, lens=[64, 40],
                        window=20, **g))):
        errs = check_case(case, got=shard_partials(case))
        print(f"[kernel] flash_decode {GEMMA} shard partial {label}: err "
              f"{err_text(errs)} (tol {_tol(case['q'].dtype):g})",
              flush=True)
    check_merge(f"{GEMMA} bf16 B 1 S {S} P 4, window {c.window}, length "
                f"{clen}", 1, S, P, 128, bf16, seed=64, lens=[clen],
                window=c.window, **g)
    check_merge(f"{GEMMA} f32 B 2 S 64 P 4, window 20, lengths 64 40", 2,
                64, 4, 128, f32, seed=65, lens=[64, 40], window=20, **g)
    main = shard_case(1, S, P, 2, 128, bf16, seed=66, lens=[clen],
                      window=c.window, **g)
    errs = check_case(main, got=shard_partials(main))
    t = dict(time_case(main), max_abs_err=errs["max_abs_err"])
    print(f"[kernel] flash_decode {GEMMA} shard partial, the gemma phase's "
          f"decode shape (rank 2 of 4: B 1, Sp {S // P} of S {S}, offset "
          f"{2 * (S // P)}, length {clen}, window {c.window}, bf16, "
          f"{c.n_heads}/{c.n_kv_heads} heads, dh 128, softcap "
          f"{c.attn_softcap:g}, scale {c.query_scale:.6g}, splits "
          f"{splits_of(main['q'], c.n_kv_heads, S // P)}): kernel "
          f"{t['ms']*1e3:.2f} us, bound {t['bound_ms']*1e3:.2f} us "
          f"({t['bound_by']}), plain {t['plain_ms']*1e3:.2f} us, sdpa "
          f"yardstick over the block {t['library_ms']*1e3:.2f} us (sdpa "
          f"computes no softcap)", flush=True)
    return t


# ---------------------------------------------------------------------------
# phase 3: paged flash-decode against its plain version
# ---------------------------------------------------------------------------

def paged_case(B, ps, MP, dh, dtype, *, seed, softcap=None, shuffled=True,
               shared=False, trash=True, masked_row=False, lens=None):
    """Pools of P = B·MP pages plus the trash page (id P); ragged lengths
    (or ``lens``); each row's pages drawn from a permutation of the page
    ids (or in order), table entries past a row's pages on the trash page
    (or on other pages); ``shared`` points row 1's first pages at
    row 0's."""
    import torch
    from repro_torch.kernels.flash_decode import validity_bias
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)
    P = B * MP
    q = randn(B, N_HEADS, dh)
    k_pool = randn(P + 1, ps, N_KV, dh)
    v_pool = randn(P + 1, ps, N_KV, dh)
    lens = (torch.randint(1, MP * ps + 1, (B,), generator=g, device="cuda")
            if lens is None else torch.tensor(lens, device="cuda"))
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
    S = args[3].shape[1] * args[1].shape[1]
    if (~live).any():
        if not ((got[1][~live] == -1e30).all()
                and (got[2][~live] == S).all()):
            raise AssertionError(f"flash_decode_paged {label}: fully masked "
                                 f"row: want m=-1e30, l={S}")
        errs["masked o"] = rel_err(got[0][~live], want[0][~live])
        if not errs["masked o"] <= tol:
            raise AssertionError(f"flash_decode_paged {label}: fully masked "
                                 f"row: o = sum v off by "
                                 f"{errs['masked o']:.3e} > {tol:g}")
    print(f"[kernel] flash_decode_paged {label}, splits "
          f"{splits_of(args[0], N_KV, S)}: err {err_text(errs)} (tol "
          f"{tol:g})", flush=True)
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
             paged_case(4, 8, 16, 64, bf16, seed=40, masked_row=True)),
            ("bf16 ps=5 rows of length 1 and full, shared, trash",
             paged_case(4, 5, 40, 64, bf16, seed=41, shared=True,
                        lens=[200, 200, 1, 1])),
            ("f32 ps=8 rows of length 1 and full, shared, trash",
             paged_case(4, 8, 32, 64, f32, seed=42, shared=True,
                        lens=[256, 256, 1, 129])),
            ("bf16 B=1 ps=16 MP=128, length 1 (many splits)",
             paged_case(1, 16, 128, 64, bf16, seed=43, lens=[1])),
            ("bf16 B=1 ps=5 MP=400 full, softcap=50",
             paged_case(1, 5, 400, 64, bf16, seed=44, softcap=50.0,
                        lens=[2000])),
            ("f32 B=2 ps=8 MP=64 dh=128, row 0 fully masked",
             paged_case(2, 8, 64, 128, f32, seed=45, masked_row=True))):
        check_paged(label, case)
    t = dict(time_paged(main), max_abs_err=err)
    S = main["args"][3].shape[1] * main["args"][1].shape[1]
    print(f"[kernel] flash_decode_paged serving shape, splits "
          f"{splits_of(main['args'][0], N_KV, S)}: kernel "
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


# the measured backend's sweeps: llama3.2-1b over the paper's batches (the
# curve H100_SXM is fitted to), the other dense archs over three
FIT_SPEC = dict(batches=(1, 2, 4, 8, 16, 32), crs=(9.9,),
                bandwidths_mbps=(400.0,))
ARCH_SPEC = dict(batches=(1, 8, 32), crs=(9.9,), bandwidths_mbps=(400.0,))
DECIDE_BATCHES = (1, 8, 32)


class PowerSampler:
    """``nvidia-smi`` sampling the card's power draw every 100 ms while the
    block runs → ``watts`` (one reading a line)."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=power.draw",
             "--format=csv,noheader,nounits", "-lms", "100", "-i", "0"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        time.sleep(0.5)                   # let the first readings land
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        self.watts = [float(x) for x in out.split()
                      if x.replace(".", "", 1).isdigit()]
        return False


def measured_profile(session, spec: dict, iters: int):
    """``profile(backend="measured")`` on the H100 presets → (perf map,
    anchor scale, {plan key: {batch: measured forward ms}}), the last two
    as the backend reports them (its CUDA-event medians)."""
    from repro_torch.profiling import (H100_GLOO_STAGED, H100_SXM,
                                       SweepSpec, get_backend)
    pm = session.profile(SweepSpec(**spec), backend="measured",
                         hardware=H100_SXM, link=H100_GLOO_STAGED,
                         iters=iters, warmup=2)
    backend = get_backend("measured")
    raw = {key: {B: t * 1e3 for B, t in times.items()}
           for key, times in backend.last_times.items()}
    return pm, backend.last_scale, raw


def print_measured(arch: str, pm, scale: float, raw: dict, card: str,
                   note: str = "") -> None:
    batches = sorted(raw["local"])
    rows = "; ".join(f"B={b}: " + ", ".join(
        f"{key} {raw[key][b]:.2f} ms" for key in raw) for b in batches)
    print(f"[measured] {arch}{note}: forward of B x 32 zero tokens, median "
          f"between CUDA events per (plan, batch): {rows}; anchor "
          f"scale {scale:.3f} (H100_SXM's local({batches[0]}) over the "
          f"measured one; 1 = the preset predicts this arch); map stamped "
          f"{pm.hardware.name!r} / {pm.link.name!r} [{card}]", flush=True)


def fit_hardware(batches, times_ms, flops_per_sample: float) -> dict:
    """The cost model's ``local`` form, ``t(B) = F·B / eff(B) + launch`` with
    ``eff(B) = eff_inf - eff_slope/B``, fitted to measured forward times by
    the least squared relative error in t, within the bounds that keep the
    form physical: ``0 <= launch < min t``, ``0 <= eff_slope/eff_inf <
    min B`` (so eff > 0 at every swept batch) and ``eff_inf <= PEAK_FLOPS``.
    ``launch`` and ``s = eff_slope/eff_inf`` run over a grid; at each grid
    point ``t - launch = F·B²/(B - s) · u`` is linear in ``u = 1/eff_inf``,
    whose bounded optimum has a closed form.  A host-bound curve, flat in B
    with noise, fits as well (launch near the fastest time), so no timing
    can leave the fit without an answer."""
    import numpy as np
    B = np.asarray(batches, float)
    t = np.asarray(times_ms, float)
    launch = np.linspace(0.0, 0.98 * t.min(), 491)[:, None, None]
    s = np.linspace(0.0, 0.99 * B.min(), 100)[None, :, None]
    a = flops_per_sample * 1e3 * B ** 2 / (B - s)          # ms per (1/FLOP/s)
    w = 1.0 / t ** 2
    u = np.maximum((a * (t - launch) * w).sum(-1) / (a * a * w).sum(-1),
                   1.0 / PEAK_FLOPS["bfloat16"])
    pred = a * u[..., None] + launch
    err = (((pred - t) / t) ** 2).sum(-1)
    i, j = np.unravel_index(np.argmin(err), err.shape)
    inf = 1.0 / float(u[i, j])
    return dict(eff_inf=inf, eff_slope=float(s[0, j, 0]) * inf,
                launch_overhead_ms=float(launch[i, 0, 0]),
                max_rel_err=float(np.max(np.abs(pred[i, j] - t) / t)))


def phase_session(card: str):
    """llama3.2-1b at full width: the measured profile on the H100 presets
    (the curve ``H100_SXM`` is fitted to, power sampled beside it) with
    the simulated Jetson decision beside each measured one, dispatch, and
    greedy generate under ``local`` and ``prism_sim`` with flash-decode
    launches counted → (launches, session)."""
    import torch
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.core.costmodel import vit_flops_per_sample
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.profiling import H100_SXM, workload_from_config
    t0 = time.perf_counter()
    session = InferenceSession.from_config(
        ARCH, reduced=False, device="cuda",
        plans=[ExecutionPlan.local(), ExecutionPlan.prism_sim(L=4, cr=9.9)])
    cfg = session.cfg
    session.profile(backend="simulated")
    jetson = {B: session.decide(B) for B in DECIDE_BATCHES}
    torch.cuda.synchronize()
    print(f"[session] {cfg.name} full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, dh {cfg.hd},"
          f" vocab {cfg.vocab_size}, {cfg.dtype}) built and profiled "
          f"(simulated) in {time.perf_counter() - t0:.1f} s", flush=True)
    with PowerSampler() as idle:
        time.sleep(1.5)
    with PowerSampler() as busy:
        pm, scale, raw = measured_profile(session, FIT_SPEC, iters=20)
    print_measured(cfg.name, pm, scale, raw, card)
    flops = vit_flops_per_sample(workload_from_config(cfg))
    fit = fit_hardware(sorted(raw["local"]),
                       [raw["local"][b] for b in sorted(raw["local"])], flops)
    if not (idle.watts and busy.watts):
        raise AssertionError("nvidia-smi gave no power.draw readings")
    idle_w = statistics.median(idle.watts)
    busy_w = statistics.mean(busy.watts)
    fit["power_active_w"] = busy_w - idle_w
    print(f"[fit] H100_SXM from this run's local curve ({cfg.name}, "
          f"{flops / 1e9:.2f} GFLOP a sample by the cost model's count): "
          f"eff_inf {fit['eff_inf']:.4g}, eff_slope {fit['eff_slope']:.4g} "
          f"FLOP/s, launch_overhead_ms {fit['launch_overhead_ms']:.3f} "
          f"(worst relative error {fit['max_rel_err']:.1%}); power draw "
          f"{busy_w:.1f} W (mean of {len(busy.watts)} readings during the "
          f"sweep) less {idle_w:.1f} W (median of {len(idle.watts)} idle) = "
          f"power_active_w {fit['power_active_w']:.1f}; the preset holds "
          f"eff_inf "
          f"{H100_SXM.eff_inf:.4g}, eff_slope {H100_SXM.eff_slope:.4g}, "
          f"launch_overhead_ms {H100_SXM.launch_overhead_ms:.3f}, "
          f"power_active_w {H100_SXM.power_active_w:.1f} [{card}]",
          flush=True)
    for B in DECIDE_BATCHES:
        d, x, j = session.decide(B), session.explain(B), jetson[B]
        print(f"[decide] B={B} @ {session.bandwidth:g} Mbps → {d.mode}"
              + (f" CR={d.cr:g}" if d.cr else "")
              + f" ({d.expected.per_sample_ms:.2f} ms/sample, measured on "
              f"{pm.hardware.name}), plan {x.plan_key!r}, batch crossover "
              f"{x.batch_crossover}, bandwidth crossover "
              f"{x.bandwidth_crossover}; simulated jetson-orin-nano/wifi-gloo"
              f" picked {j.mode}" + (f" CR={j.cr:g}" if j.cr else "")
              + f" ({j.expected.per_sample_ms:.1f} ms/sample modeled)",
              flush=True)
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
        launches, _ = drive_generate(session, prompt, key, n_steps, card)
        total += launches
    return total, session


def drive_generate(session, prompt, key: str, n_steps: int, card: str,
                   note: str = "", breakdown: bool = True):
    """Greedy ``generate`` of N_NEW tokens under plan ``key``, flash-decode
    launches counted around it and asserted = n_steps × layers, tokens and
    the logits over the generated sequence checked (the last position's
    when the prompt is longer than PROMPT_T); with ``breakdown``, the
    ``local`` plan's kernel time read by ``torch.profiler`` → (launches,
    decode ms per token step)."""
    from repro_torch.models import transformer as tfm
    import torch
    from repro_torch.kernels.flash_decode import flash_decode
    cfg = session.cfg
    plan = session.plans[key]
    timed_generate(session, prompt, 2, plan)                 # warm-up
    _, w1 = timed_generate(session, prompt, 1, plan)
    flash_decode.launches = 0
    out, w = timed_generate(session, prompt, N_NEW, plan)
    launches = flash_decode.launches
    want = n_steps * cfg.n_layers
    if launches != want:
        raise AssertionError(f"{cfg.name} {key}: flash_decode launched "
                             f"{launches} times, want {want}")
    B, T0 = prompt.shape
    if out.shape != (B, N_NEW) or not (
            (out >= 0) & (out < cfg.vocab_size)).all():
        raise AssertionError(f"{cfg.name} {key}: bad tokens "
                             f"{tuple(out.shape)}")
    seq = torch.cat([prompt, out.to(prompt.dtype)], dim=1)
    if T0 > PROMPT_T:                   # [B, N, V] f32 would not fit
        with torch.inference_mode():
            lg = tfm.forward_lm(session.params, {"tokens": seq}, cfg,
                                plan.to_exchange_config(), last_only=True)[0]
    else:
        lg = session.run(key, {"tokens": seq})
    if not torch.isfinite(lg).all():
        raise AssertionError(f"{cfg.name} {key}: non-finite logits over the "
                             f"generated sequence")
    del lg
    decode_ms = (w - w1) / (N_NEW - 1)
    print(f"[generate] {cfg.name}{note} {key}: [{B}, {T0}] "
          f"prompt + {N_NEW} greedy tokens in {w:.1f} ms; flash_decode "
          f"launches {launches} (= {n_steps} steps x {cfg.n_layers} layers);"
          f" decode {decode_ms:.2f} ms/token step, "
          f"{B / decode_ms * 1e3:.1f} tokens/s at B={B} "
          f"[{card}]", flush=True)
    if key == "local" and breakdown:
        print_breakdown(f"{cfg.name} {key}", lambda: session.generate(
            prompt, N_NEW, plan=plan), w)
    return launches, decode_ms


def layers_that_fit(cfg, headroom_bytes: float = 6e9) -> int:
    """How many of ``cfg``'s layers fit in the card's free memory at full
    width beside its embedding and head, with ``headroom_bytes`` left for
    activations."""
    import torch
    d, hd, f = cfg.d_model, cfg.hd, cfg.d_ff
    per_layer = (d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
                 + 3 * d * f + 2 * d
                 + (hd * (cfg.n_heads + 2 * cfg.n_kv_heads)
                    if cfg.qkv_bias else 0)) * 2
    head = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2) * 2 + 2 * d
    free = torch.cuda.mem_get_info()[0]
    n = min(cfg.n_layers, int((free - head - headroom_bytes) // per_layer))
    return n - n % 2 if cfg.local_global else n  # whole local/global pairs


def phase_arch_session(card: str, arch: str) -> dict:
    """``arch`` at full width, bf16, on the card (all its layers if they fit
    beside nothing else): the measured profile on the H100 presets over
    three batches, decide and explain at B 1, 8 and 32, and greedy
    ``generate`` under ``local`` with flash-decode launches asserted
    (gemma2 has no ``prism_sim`` plan: it raises on windowed layers, as in
    the JAX package; it generates a second time at B 1 from a
    GEMMA_LONG-token prompt, past its window) → (launches, layers driven,
    and gemma2's B 1 launches)."""
    import dataclasses
    import gc
    import torch
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    full = get_config(arch)
    n_layers = layers_that_fit(full)
    cfg = dataclasses.replace(full, n_layers=n_layers)
    params = registry.init_params(cfg, seed=0, device="cuda")
    plans = [ExecutionPlan.local()] + (
        [] if cfg.local_global else [ExecutionPlan.prism_sim(L=4, cr=9.9)])
    session = InferenceSession(cfg, params, device="cuda", plans=plans)
    n_params = sum(t.numel() for t in _leaves(params))
    del params
    torch.cuda.synchronize()
    note = ("" if n_layers == full.n_layers
            else f" ({n_layers} of {full.n_layers} layers)")
    print(f"[session] {arch} full width ({n_layers} of {full.n_layers} "
          f"layers, d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
          f"dh {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, qkv_bias "
          f"{cfg.qkv_bias}, kv_quant {cfg.kv_quant}, {cfg.dtype}; "
          f"{n_params / 1e9:.2f} B parameters drawn on the card from seed 0) "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    pm, scale, raw = measured_profile(session, ARCH_SPEC, iters=3)
    print_measured(arch, pm, scale, raw, card, note)
    for B in DECIDE_BATCHES:
        d, x = session.decide(B), session.explain(B)
        print(f"[decide] {arch} B={B} @ {session.bandwidth:g} Mbps → "
              f"{d.mode}" + (f" CR={d.cr:g}" if d.cr else "")
              + f" ({d.expected.per_sample_ms:.2f} ms/sample, measured on "
              f"{pm.hardware.name}), plan {x.plan_key!r}, batch crossover "
              f"{x.batch_crossover}, bandwidth crossover "
              f"{x.bandwidth_crossover}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (PROMPT_B, PROMPT_T),
                           generator=g, device="cuda")
    launches, _ = drive_generate(session, prompt, "local", N_NEW - 1, card,
                                 note)
    out = dict(launches=launches, n_layers=n_layers)
    if cfg.local_global:
        long = torch.randint(0, cfg.vocab_size, (1, GEMMA_LONG), generator=g,
                             device="cuda")
        out["long_launches"], _ = drive_generate(
            session, long, "local", N_NEW - 1, card,
            f"{note} (window {cfg.window} masks every decode step)",
            breakdown=False)
    peak = torch.cuda.max_memory_allocated()
    print(f"[memory] {arch}{note}: peak allocated {peak / 1e9:.2f} GB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB "
          f"[{card}]", flush=True)
    del session
    gc.collect()
    torch.cuda.empty_cache()
    return out


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


def check_seg_kv(label: str, case) -> float:
    """The K+V call (one launch) vs the plain version applied to each →
    max abs error; raises past tolerance."""
    import torch
    from repro_torch.kernels.segment_means import (segment_means,
                                                   segment_means_kv,
                                                   segment_means_ref)
    x, L, mask = case
    y = torch.flip(x, dims=(2,)).contiguous()          # a second input
    before = segment_means.launches
    got, got_c = segment_means_kv(x, y, L, mask)
    torch.cuda.synchronize()
    if segment_means.launches != before + 1:
        raise AssertionError(f"segment_means K+V {label}: not one launch")
    err, tol, worst = 0.0, _tol(x.dtype), 0.0
    for i, t in enumerate((x, y)):
        want, want_c = segment_means_ref(t, L, mask)
        err = max(err, rel_err(got[i], want))
        worst = max(worst, (got[i].float() - want.float()).abs().max().item())
        if not torch.equal(got_c, want_c):
            raise AssertionError(f"segment_means K+V {label}: counts differ")
    if not err <= tol:
        raise AssertionError(f"segment_means K+V {label}: relative error "
                             f"{err:.3e} > {tol:g}")
    print(f"[kernel] segment_means K+V {label}: rel err {err:.2e} (tol "
          f"{tol:g}), counts exact, one launch", flush=True)
    return worst


def time_seg(case) -> dict:
    """The K+V call at ``case``'s shape (K and V the same shape, one
    launch, as the exchange calls it) beside the plain version and one
    ``mean()`` over K and V stacked outside the timing; and the
    one-input call alone."""
    import torch
    from repro_torch.kernels.segment_means import (segment_means,
                                                   segment_means_kv,
                                                   segment_means_ref)
    x, L, mask = case
    B, N, D = x.shape
    copies = cold_copies((x, x.clone(), mask))
    moved = (2 * nbytes(x) + nbytes(mask) + 2 * B * L * D * x.element_size()
             + B * L * 4)
    b_ms, b_by = roofline(moved, 4 * B * N * D, x.dtype)   # x·mask, add

    def plain(k, v, m):
        return [segment_means_ref(t, L, m) for t in (k, v)]
    # yardstick only: one PyTorch call over K and V stacked, unmasked (the
    # port never calls it)
    stacked = [(torch.stack([k, v]),) for k, v, _ in copies]
    return {
        "ms": time_ms(lambda k, v, m: segment_means_kv(k, v, L, m), copies),
        "one_input_ms": time_ms(lambda k, v, m: segment_means(k, L, m),
                                copies),
        "plain_ms": time_ms(plain, copies),
        "library_ms": time_ms(
            lambda kv: kv.unflatten(2, (L, N // L)).mean(
                3, dtype=torch.float32), stacked),
        "bound_ms": b_ms, "bound_by": b_by}


def prism_case(B, Np, H, Hk, dh, P, L, dtype, *, seed, causal=False,
               part=0, masked=True, softcap=None, dead_row=False,
               strided=False, scale=None):
    """Local q/K/V of one partition, every partition's means, and the
    mean bias built as the exchange builds it (own partition hidden; with a
    mask, per-segment counts, one segment empty).  ``strided``: the means
    as the exchange hands them to the kernel, [B, P, L, Hk, dh] views of
    the gathered [P, 2, B, L, Hk, dh] payload; else flat [B, P·L, Hk,
    dh]."""
    import torch
    from repro_torch.kernels.prism_attention import build_mean_bias
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)
    q, k, v = randn(B, Np, H, dh), randn(B, Np, Hk, dh), randn(B, Np, Hk, dh)
    if strided:
        km, vm = randn(P, 2, B, L, Hk, dh).permute(1, 2, 0, 3, 4, 5)
    else:
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
                softcap=softcap, scale=scale)


def _flat(means):
    """Means as [B, P·L, Hk, dh] (a copy where they are the exchange's
    strided view)."""
    return means.flatten(1, 2) if means.ndim == 5 else means


def prism_bound(case) -> tuple:
    """PRISM attention: q in and the output out; the bias and the mask;
    and the K and V rows of the keys a query of the batch row can see (its
    unmasked local keys, causal ones at or before the query's position
    included; its means with a bias above -1e30; every key for a row that
    sees none).  4·H·dh flops per (query, key it sees): under causal
    attention query i sees the unmasked local keys 0..i, not all of
    them."""
    import torch
    q, k, v, km, vm, bias, mask = case["args"]
    B, Nq, H, dh = q.shape
    Nk, Hk, M = k.shape[1], k.shape[2], bias.shape[1]
    local = (mask if mask is not None
             else torch.ones(B, Nk, dtype=torch.bool, device=q.device))
    seen = local.long().cumsum(dim=1)                   # [B, Nk]
    if case["causal"]:                                  # q_offset 0
        pos = torch.arange(Nq, device=q.device).clamp(max=Nk - 1)
        per_q = seen[:, pos]                            # [B, Nq]
    else:
        per_q = seen[:, -1:].expand(B, Nq)
    per_q = per_q + (bias > -1e30).sum(dim=1, keepdim=True)
    per_q = per_q.masked_fill(per_q == 0, Nk + M)
    keys = per_q.max(dim=1).values      # rows of K and V a batch row reads
    moved = (2 * nbytes(q) + nbytes(bias, mask)
             + 2 * int(keys.sum()) * Hk * dh * k.element_size())
    return roofline(moved, 4 * H * dh * int(per_q.sum()), q.dtype)


def _copy_prism_args(args):
    """A copy of PRISM-attention inputs, strided means laid out as the
    originals (views of one gathered [P, 2, B, L, Hk, dh] tensor)."""
    import torch
    q, k, v, km, vm, bias, mask = args
    if km.ndim == 5:
        gathered = torch.stack([km, vm]).permute(2, 0, 1, 3, 4, 5).contiguous()
        km, vm = gathered.permute(1, 2, 0, 3, 4, 5)
    else:
        km, vm = km.clone(), vm.clone()
    return (q.clone(), k.clone(), v.clone(), km, vm, bias.clone(),
            None if mask is None else mask.clone())


def _prism_calls(case):
    from repro_torch.kernels.prism_attention import (prism_attention,
                                                     prism_attention_ref)
    causal, cap, scale = case["causal"], case["softcap"], case["scale"]

    def kernel(q, k, v, km, vm, bias, mask, out_dtype=None):
        return prism_attention(q, k, v, km, vm, bias, causal=causal,
                               scale=scale, softcap=cap, kv_mask=mask,
                               out_dtype=out_dtype)

    def plain(q, k, v, km, vm, bias, mask, out_dtype=None):
        return prism_attention_ref(q, k, v, _flat(km), _flat(vm), bias,
                                   causal=causal, scale=scale,
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
    """Kernel (with ``row_plan``'s warps, and with 2 CTAs of 4 consumer
    warps per (batch row, KV head) where that differs), plain version and
    the sdpa yardstick, inputs cold in L2."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.prism_attention import kernel as pk
    kernel, plain = _prism_calls(case)
    q, k, v, km, vm, bias, mask = case["args"]
    B, Nq, H, dh = q.shape
    Nk, M = k.shape[1], bias.shape[1]
    copies = [case["args"]] + [_copy_prism_args(case["args"]) for _ in range(
        min(255, int(2 * L2_BYTES // nbytes(*case["args"]))))]
    b_ms, b_by = prism_bound(case)

    # yardstick only: sdpa over [K_loc ‖ K_means] with the bias as a float
    # mask, in its own [B, heads, N, dh] layout made outside the timing
    def sdpa_args(q, k, v, km, vm, bias, mask):
        keys = torch.where(mask, 0.0, -1e30) if mask is not None else \
            torch.zeros(B, Nk, device=q.device)
        full = torch.cat([keys, bias], dim=1).to(q.dtype)
        return (q.transpose(1, 2), torch.cat([k, _flat(km)], 1)
                .transpose(1, 2).contiguous(),
                torch.cat([v, _flat(vm)], 1).transpose(1, 2).contiguous(),
                full[:, None, None, :].expand(B, 1, Nq, Nk + M))
    lib_args = [sdpa_args(*a) for a in copies]
    out = {
        "ms": time_ms(kernel, copies),
        "plain_ms": time_ms(plain, copies),
        "library_ms": time_ms(
            lambda q, k, v, m: F.scaled_dot_product_attention(
                q, k, v, attn_mask=m, enable_gqa=True, scale=case["scale"]),
            lib_args),
        "bound_ms": b_ms, "bound_by": b_by,
        "warps": pk.row_plan(Nq * (H // k.shape[2]))}
    plan = pk.row_plan
    pk.row_plan = lambda rows: min(4, plan(rows))     # 2 CTAs at ViT
    try:
        out["split_ms"] = time_ms(kernel, copies)
    finally:
        pk.row_plan = plan
    return out


def phase_exchange_kernels() -> dict:
    """Both exchange kernels at the ViT-B/16 shapes of the 2-rank PRISM
    forward (per rank: K/V [8, 100, 12, 64] bf16, L = 20, means
    [8, 2, 20, 12, 64] as the gather leaves them) and at harder ones."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    np_ = 200 // VIT_P
    out = {}
    main = seg_case(VIT_B, np_, (12, 64), VIT_L, bf16, seed=10)
    check_seg("ViT bf16 [8, 100, 12·64] L=20 masked, empty segment", main)
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
    err = check_seg_kv("ViT bf16 2 x [8, 100, 12·64] L=20 masked, empty "
                       "segment", main)
    for label, case in (
            ("ViT bf16 unmasked", seg_case(VIT_B, np_, (12, 64), VIT_L,
                                           bf16, seed=15, masked=False)),
            ("ViT f32 masked", seg_case(VIT_B, np_, (12, 64), VIT_L, f32,
                                        seed=16)),
            ("bf16 odd D [8, 100, 771] L=20 masked (scalar path)",
             seg_case(VIT_B, np_, (771,), VIT_L, bf16, seed=17))):
        check_seg_kv(label, case)
    out["segment_means"] = dict(time_seg(main), max_abs_err=err)
    t = out["segment_means"]
    print(f"[kernel] segment_means ViT main shape, K and V in one launch: "
          f"kernel {t['ms']*1e3:.2f} us (one input alone "
          f"{t['one_input_ms']*1e3:.2f} us), bound {t['bound_ms']*1e3:.2f} "
          f"us ({t['bound_by']}), plain {t['plain_ms']*1e3:.2f} us, mean() "
          f"yardstick over K and V stacked {t['library_ms']*1e3:.2f} us",
          flush=True)

    main = prism_case(VIT_B, np_, 12, 12, 64, VIT_P, VIT_L, bf16, seed=20,
                      strided=True)
    err = check_prism("ViT bf16 q/K/V [8, 100, 12, 64], means [8, 2, 20, "
                      "12, 64] strided as gathered, masked, empty segment, "
                      "part 0", main)
    out["prism_attention"] = dict(time_prism(main), max_abs_err=err)
    for label, case in (
            ("ViT bf16 strided part 1",
             prism_case(VIT_B, np_, 12, 12, 64, VIT_P, VIT_L, bf16, seed=27,
                        part=1, strided=True)),
            ("ViT bf16 flat means [8, 40, 12, 64] part 1",
             prism_case(VIT_B, np_, 12, 12, 64, VIT_P, VIT_L, bf16, seed=28,
                        part=1)),
            ("ViT f32", prism_case(VIT_B, np_, 12, 12, 64, VIT_P, VIT_L, f32,
                                   seed=21, part=1)),
            ("causal GQA 32/8 dh 64 bf16 Np=512 P=4 L=16 part 2",
             prism_case(2, 512, 32, 8, 64, 4, 16, bf16, seed=22, causal=True,
                        part=2, masked=False)),
            ("causal GQA 32/8 bf16 Np=512 P=4 L=16 part 1 strided, masked "
             "(future local and mean tiles skipped)",
             prism_case(2, 512, 32, 8, 64, 4, 16, bf16, seed=29, causal=True,
                        part=1, strided=True)),
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
                        dead_row=True, strided=True))):
        check_prism(label, case)
    t = out["prism_attention"]
    print(f"[kernel] prism_attention ViT main shape: kernel "
          f"{t['ms']*1e3:.2f} us (1 CTA of {t['warps']} + 1 warps per batch "
          f"row and KV head; 2 CTAs of 4 + 1: {t['split_ms']*1e3:.2f} us), "
          f"bound {t['bound_ms']*1e3:.2f} us ({t['bound_by']}), plain "
          f"{t['plain_ms']*1e3:.2f} us, sdpa yardstick "
          f"{t['library_ms']*1e3:.2f} us", flush=True)

    # the lm phase's prism forward: llama3.2-1b per rank, B 4, Np 256
    lm_np = LM_N // LM_P
    seg = seg_case(LM_B, lm_np, (N_KV, 64), LM_L, bf16, seed=30,
                   masked=False)
    err = check_seg_kv(f"llama3.2-1b bf16 2 x [{LM_B}, {lm_np}, {N_KV}·64] "
                       f"L={LM_L} unmasked", seg)
    out["segment_means_lm"] = t = dict(time_seg(seg), max_abs_err=err)
    print(f"[kernel] segment_means llama3.2-1b prism shape, K and V in one "
          f"launch: kernel {t['ms']*1e3:.2f} us, bound "
          f"{t['bound_ms']*1e3:.2f} us ({t['bound_by']}), plain "
          f"{t['plain_ms']*1e3:.2f} us, mean() yardstick "
          f"{t['library_ms']*1e3:.2f} us", flush=True)
    lm = prism_case(LM_B, lm_np, N_HEADS, N_KV, 64, LM_P, LM_L, bf16,
                    seed=31, causal=True, part=1, masked=False, strided=True)
    err = check_prism(f"llama3.2-1b causal GQA {N_HEADS}/{N_KV} bf16 "
                      f"[{LM_B}, {lm_np}] L={LM_L} P={LM_P} part 1, means "
                      f"strided as gathered", lm)
    check_prism("llama3.2-1b causal part 0 (no earlier partition's means)",
                prism_case(LM_B, lm_np, N_HEADS, N_KV, 64, LM_P, LM_L, bf16,
                           seed=32, causal=True, part=0, masked=False,
                           strided=True))
    out["prism_attention_lm"] = t = dict(time_prism(lm), max_abs_err=err)
    print(f"[kernel] prism_attention llama3.2-1b prism shape (part 1, "
          f"causal): kernel {t['ms']*1e3:.2f} us ({t['warps']} + 1 warps; 2 "
          f"CTAs of 4 + 1: {t['split_ms']*1e3:.2f} us), bound "
          f"{t['bound_ms']*1e3:.2f} us ({t['bound_by']}), plain "
          f"{t['plain_ms']*1e3:.2f} us, sdpa yardstick "
          f"{t['library_ms']*1e3:.2f} us", flush=True)

    # the gemma phase's prism forward: a global layer of gemma2-27b per
    # rank, B 1, Np 2048 of 8192 over 4 ranks
    from repro_torch.configs import get_config
    c = get_config(GEMMA)
    gnp, H, Hk = GEMMA_N // GEMMA_P, c.n_heads, c.n_kv_heads
    seg = seg_case(1, gnp, (Hk, c.hd), GEMMA_L, bf16, seed=35, masked=False)
    err = check_seg_kv(f"{GEMMA} bf16 2 x [1, {gnp}, {Hk}·{c.hd}] "
                       f"L={GEMMA_L} unmasked", seg)
    out["segment_means_gemma"] = t = dict(time_seg(seg), max_abs_err=err)
    print(f"[kernel] segment_means {GEMMA} prism shape, K and V in one "
          f"launch: kernel {t['ms']*1e3:.2f} us, bound "
          f"{t['bound_ms']*1e3:.2f} us ({t['bound_by']}), plain "
          f"{t['plain_ms']*1e3:.2f} us, mean() yardstick "
          f"{t['library_ms']*1e3:.2f} us", flush=True)
    g = dict(causal=True, masked=False, strided=True, softcap=c.attn_softcap,
             scale=c.query_scale)
    check_prism(f"{GEMMA} causal GQA {H}/{Hk} dh {c.hd} bf16 [1, {gnp}] "
                f"L={GEMMA_L} P={GEMMA_P} part 0, softcap "
                f"{c.attn_softcap:g}, scale 1/12",
                prism_case(1, gnp, H, Hk, c.hd, GEMMA_P, GEMMA_L, bf16,
                           seed=36, part=0, **g))
    gm = prism_case(1, gnp, H, Hk, c.hd, GEMMA_P, GEMMA_L, bf16, seed=37,
                    part=GEMMA_P - 1, **g)
    err = check_prism(f"{GEMMA} part {GEMMA_P - 1} (every earlier "
                      f"partition's means), means strided as gathered", gm)
    out["prism_attention_gemma"] = t = dict(time_prism(gm), max_abs_err=err)
    print(f"[kernel] prism_attention {GEMMA} prism shape (part "
          f"{GEMMA_P - 1}, causal, softcap, scale 1/12): kernel "
          f"{t['ms']*1e3:.2f} us ({t['warps']} + 1 warps; 2 CTAs of 4 + 1: "
          f"{t['split_ms']*1e3:.2f} us), bound {t['bound_ms']*1e3:.2f} us "
          f"({t['bound_by']}), plain {t['plain_ms']*1e3:.2f} us, sdpa "
          f"yardstick {t['library_ms']*1e3:.2f} us (sdpa computes no "
          f"softcap)", flush=True)
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


SMALL_LM_B, SMALL_LM_N, SMALL_LM_T0, SMALL_LM_NEW, SMALL_LM_STEPS = (
    2, 32, 16, 8, 12)
SMALL_LM_L = 4


def _small_llama():
    """(cfg, CPU params from seed 0, forward tokens, prompt, decode
    tokens) of the small f32 llama."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    cfg = get_config(ARCH).reduced(**SMALL_LLAMA)
    params = registry.init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(0)
    return (cfg, params,
            *(torch.randint(0, cfg.vocab_size, (SMALL_LM_B, n), generator=g)
              for n in (SMALL_LM_N, SMALL_LM_T0, SMALL_LM_STEPS)))


def _decode_steps(params, cfg, xcfg, steps, device):
    """Logits of SMALL_LM_STEPS decode steps from a fresh cache (sharded
    under a partitioned ``xcfg``) → [B, steps, V] on the CPU."""
    import torch
    from repro_torch.models import transformer as tfm
    cache = tfm.init_decode_cache(cfg, steps.shape[0], steps.shape[1],
                                  device=device, xcfg=xcfg)
    out = []
    with torch.inference_mode():
        for t in range(steps.shape[1]):
            lg, cache = tfm.decode_step(params,
                                        {"tokens": steps[:, t:t + 1].to(
                                            device)}, cache, t, cfg, xcfg)
            out.append(lg.cpu())
    return torch.cat(out, dim=1)


def _small_lm_rank(rank, world):
    """One rank of the small f32 llama on the card: ``voltage`` and
    ``prism`` forward logits, sharded decode steps, greedy tokens."""
    from repro_torch.api import ExecutionPlan, InferenceSession
    _exact_fp32()
    cfg, params, tokens, prompt, steps = _small_llama()
    volt = ExecutionPlan.voltage(seq_shards=world)
    prism = ExecutionPlan.prism(L=SMALL_LM_L, cr=1.0, seq_shards=world)
    session = InferenceSession.from_config(
        ARCH, reduced=SMALL_LLAMA, params=_on(params, "cuda"), device="cuda",
        plans=[volt, prism])
    out = {f"fwd/{p.mode}": session.run(p.key, {"tokens": tokens}).cpu()
           for p in (volt, prism)}
    out["decode"] = _decode_steps(session.params, cfg,
                                  volt.to_exchange_config(), steps, "cuda")
    for plan, mode in ((volt, "auto"), (prism, "auto"),
                       (prism, "single_pass")):
        out[f"gen/{plan.mode}/{mode}"] = session.generate(
            prompt, SMALL_LM_NEW, plan=plan, prefill_mode=mode).cpu()
    return {k: v.numpy() for k, v in out.items()}


def phase_small_lm_reference() -> None:
    """The small f32 llama across 2 ranks on the card (flash-decode through
    the offset route and the merge; segment means and PRISM attention,
    causal, GQA) against one CPU process on the same weights: ``voltage``
    against ``local`` and ``prism`` against ``prism_sim`` (the forward
    logits and 12 sharded decode steps ≤ 1e-4), greedy tokens exact
    (``voltage`` and ``prism``'s decode-loop prefill against ``local``,
    the forced single-pass ``prism`` against ``prism_sim``)."""
    import numpy as np
    import torch
    from repro_torch.api.generation import generate
    from repro_torch.core.exchange import ExchangeConfig, ExchangeMode
    from repro_torch.core.seq_group import spawn
    from repro_torch.models import transformer as tfm
    cfg, params, tokens, prompt, steps = _small_llama()
    local = ExchangeConfig()
    sim = ExchangeConfig(ExchangeMode.PRISM_SIM, seq_axis="seq",
                         seq_shards=LM_P, L=SMALL_LM_L)
    with torch.inference_mode():
        want = {"fwd/voltage": tfm.forward_lm(params, {"tokens": tokens},
                                              cfg, local)[0],
                "fwd/prism": tfm.forward_lm(params, {"tokens": tokens}, cfg,
                                            sim)[0]}
    want["decode"] = _decode_steps(params, cfg, local, steps, "cpu")
    tok_local = generate(params, prompt, SMALL_LM_NEW, cfg, local)
    want_tokens = {"gen/voltage/auto": tok_local, "gen/prism/auto": tok_local,
                   "gen/prism/single_pass": generate(
                       params, prompt, SMALL_LM_NEW, cfg, sim,
                       prefill_mode="single_pass")}
    t0 = time.perf_counter()
    ranks = spawn(_small_lm_rank, LM_P, timeout=RANK_TIMEOUT_S)
    worst = {}
    for key, w in want.items():
        worst[key] = max(float(np.abs(r[key] - w.numpy()).max())
                         for r in ranks)
        if not worst[key] <= 1e-4:
            raise AssertionError(f"small f32 llama {key}: 2 ranks on the "
                                 f"card vs one CPU process differ by "
                                 f"{worst[key]:.3e} > 1e-4")
    for key, w in want_tokens.items():
        for r, got in enumerate(ranks):
            if not np.array_equal(got[key], w.numpy()):
                raise AssertionError(f"small f32 llama {key}: rank {r}'s "
                                     f"greedy tokens differ from the CPU's")
    print(f"[reference] reduced f32 llama ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, dh "
          f"{cfg.hd}): {LM_P} ranks on the card vs one CPU process, max "
          f"|logit diff| voltage forward {worst['fwd/voltage']:.2e}, "
          f"prism(L={SMALL_LM_L}) forward vs prism_sim "
          f"{worst['fwd/prism']:.2e}, {SMALL_LM_STEPS} sharded decode steps "
          f"{worst['decode']:.2e} (tol 1e-4); greedy [{SMALL_LM_B}, "
          f"{SMALL_LM_T0}] + {SMALL_LM_NEW} tokens exact on both ranks "
          f"(voltage, prism scan prefill, prism single-pass); "
          f"{time.perf_counter() - t0:.1f} s with rank start-up", flush=True)


SMALL_GEMMA_T0, SMALL_GEMMA_NEW, SMALL_GEMMA_L = 8, 24, 2
SMALL_GEMMA_N = (64, 16)       # Np 16 over 4 ranks: the halo; Np 4: Voltage


def _small_gemma():
    """(cfg, CPU params from seed 0) of the small f32 gemma2."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    cfg = get_config(GEMMA).reduced(**SMALL_GEMMA)
    return cfg, registry.init_params(cfg, seed=0, device="cpu")


def _small_gemma_rank(rank, world, device):
    """One rank of the small f32 gemma2 on ``device``: ``voltage`` and
    ``prism`` forward logits at each of SMALL_GEMMA_N tokens, with the
    bytes and calls of their staged collectives."""
    import torch
    from repro_torch.api import ExecutionPlan
    from repro_torch.core.seq_group import get_seq_group
    from repro_torch.models import transformer as tfm
    _exact_fp32()
    group = get_seq_group("seq")
    cfg, params = _small_gemma()
    params = _on(params, device)
    g = torch.Generator().manual_seed(2)
    out = {}
    for N in SMALL_GEMMA_N:
        tokens = torch.randint(0, cfg.vocab_size, (2, N), generator=g)
        for plan in (ExecutionPlan.voltage(seq_shards=world),
                     ExecutionPlan.prism(L=SMALL_GEMMA_L, cr=1.0,
                                         seq_shards=world)):
            group.reset_stats()
            with torch.inference_mode():
                lg = tfm.forward_lm(params, {"tokens": tokens.to(device)},
                                    cfg, plan.to_exchange_config())[0]
            st = group.stats
            out[(plan.mode, N)] = (lg.cpu().numpy(), st.payload_bytes,
                                   st.calls)
    return out


def phase_small_gemma_reference() -> None:
    """The small f32 gemma2 (one local/global pair, window 16, int8 KV
    cache, dh 64) on the card against the same weights on the CPU: 32
    decode steps (an 8-token prompt, then 24 steps past the window), each
    from the CPU's cache before it, logits ≤ 1e-4 with an f32 cache; with
    the int8 cache the codes each step writes within one rounding step and
    the logits printed (a code on a rounding boundary may round either way
    on the two devices and move the step's logits by ~1e-4: ROADMAP, int8
    KV rounding); greedy [2, 8] + 24 tokens exact through the int8 cache;
    then across 4 ranks on the card against 4 CPU ranks under ``voltage``
    and ``prism(L=2)`` at N 64 (the halo: n_halo 1 of P − 1 = 3) and N 16
    (n_halo 3: the Voltage gather), forward logits ≤ 1e-4, the halo's
    received bytes asserted."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.api.generation import generate
    from repro_torch.core.exchange import ExchangeConfig
    from repro_torch.core.seq_group import spawn
    from repro_torch.models import transformer as tfm
    cfg, params = _small_gemma()
    sides = {"cpu": params, "cuda": _on(params, "cuda")}
    g = torch.Generator().manual_seed(0)
    steps = SMALL_GEMMA_T0 + SMALL_GEMMA_NEW
    toks = torch.randint(0, cfg.vocab_size, (2, steps), generator=g)
    xcfg = ExchangeConfig()
    worst = {}
    for quant in (False, True):
        qcfg = dataclasses.replace(cfg, kv_quant=quant)
        worst[quant] = 0.0
        with torch.inference_mode():
            cache = tfm.init_decode_cache(qcfg, 2, steps, device="cpu")
            for t in range(steps):
                card = _on(cache, "cuda")
                step = {"tokens": toks[:, t:t + 1]}
                want, cache = tfm.decode_step(sides["cpu"], step, cache, t,
                                              qcfg, xcfg)
                got, card = tfm.decode_step(sides["cuda"], _on(step, "cuda"),
                                            card, t, qcfg, xcfg)
                worst[quant] = max(worst[quant],
                                   (got.cpu() - want).abs().max().item())
                for half, leaves in card.items():
                    for name in ("k", "v") if quant else ():
                        flip = (leaves[name][:, :, t].cpu().int()
                                - cache[half][name][:, :, t].int()).abs()
                        if flip.max() > 1:
                            raise AssertionError(
                                f"small gemma2 {half} {name} step {t}: int8 "
                                f"codes differ by {int(flip.max())}")
    if not worst[False] <= 1e-4:
        raise AssertionError(f"small f32 gemma2: card vs CPU decode logits "
                             f"differ by {worst[False]:.3e} > 1e-4")
    prompt = toks[:, :SMALL_GEMMA_T0]
    tokens = {d: generate(p, prompt.to(d), SMALL_GEMMA_NEW, cfg, xcfg).cpu()
              for d, p in sides.items()}
    if not torch.equal(tokens["cuda"], tokens["cpu"]):
        raise AssertionError("small f32 gemma2: card and CPU greedy tokens "
                             "differ")
    t0 = time.perf_counter()
    ranks = {d: spawn(_small_gemma_rank, GEMMA_P, d, timeout=RANK_TIMEOUT_S)
             for d in ("cpu", "cuda")}
    P, Hk, dh, B = GEMMA_P, cfg.n_kv_heads, cfg.hd, 2
    seen = {}
    for key in ranks["cpu"][0]:
        mode, N = key
        Np = N // P
        n_halo = min(-(-cfg.window // Np), P - 1)
        diffs = []
        for p, (c, r) in enumerate(zip(ranks["cpu"], ranks["cuda"])):
            diffs.append(float(np.abs(r[key][0] - c[key][0]).max()))
            if r[key][1:] != c[key][1:]:
                raise AssertionError(f"small gemma2 {key} rank {p}: the card"
                                     f" moved {r[key][1:]} (bytes, calls), "
                                     f"the CPU {c[key][1:]}")
            if mode == "prism" and n_halo < P - 1:
                halo = min(p, n_halo) * 2 * B * Np * Hk * dh * 4
                means = (P - 1) * 2 * B * SMALL_GEMMA_L * Hk * dh * 4
                if r[key][1] != halo + means:
                    raise AssertionError(f"small gemma2 {key} rank {p}: "
                                         f"{r[key][1]} payload bytes, the "
                                         f"halo and means are {halo + means}")
        seen[key] = max(diffs)
        if not seen[key] <= 1e-4:
            raise AssertionError(f"small gemma2 {key}: 4 ranks on the card "
                                 f"vs 4 CPU ranks differ by {seen[key]:.3e}")
    print(f"[reference] reduced f32 {GEMMA} ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, dh "
          f"{cfg.hd}, window {cfg.window}): {steps} decode steps on the card "
          f"vs the CPU, each from the CPU's cache, max |logit diff| f32 cache"
          f" {worst[False]:.2e} (tol 1e-4), int8 cache {worst[True]:.2e} "
          f"(codes within one rounding step); greedy [2, {SMALL_GEMMA_T0}] + "
          f"{SMALL_GEMMA_NEW} tokens exact; {P} ranks on the card vs {P} CPU"
          f" ranks, max |logit diff| " + ", ".join(
              f"{m} N={n} {d:.2e}" for (m, n), d in seen.items())
          + f" (tol 1e-4; prism at N={SMALL_GEMMA_N[0]} through the halo, "
          f"its bytes as predicted); {time.perf_counter() - t0:.1f} s with "
          f"rank start-up", flush=True)


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
    logits, counts, moved, received = {}, {}, {}, {}
    kv_width = 2 * cfg.n_kv_heads * cfg.hd      # K and V per token
    for key in keys:
        segment_means.launches = prism_attention.launches = 0
        group.reset_stats()
        logits[key] = session.run(key, batch)
        torch.cuda.synchronize()
        counts[key] = (segment_means.launches, prism_attention.launches)
        moved[key] = group.stats.payload_bytes
        received[key] = group.stats.payload_bytes + group.stats.meta_bytes
        plan = session.plans[key]
        want_bytes = 0 if not plan.distributed else exchange_wire_bytes(
            plan.effective_codec, n_tokens=VIT_TOKENS, d_model=kv_width,
            bytes_per_el=cfg.torch_dtype.itemsize, batch=VIT_B, P=world,
            n_layers=cfg.n_layers, L=plan.L)
        if moved[key] != want_bytes:
            raise AssertionError(f"rank {rank} {key}: gathered "
                                 f"{moved[key]} payload bytes, transport "
                                 f"accounting says {want_bytes}")
        want = ((cfg.n_layers, cfg.n_layers) if plan.mode == "prism"
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
    both = group.all_gather(prism, kind="meta")
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
                              kind="meta")
    if len(set(picked.tolist())) != 1:
        raise AssertionError(f"dispatch ran {picked.tolist()} on the ranks")
    return dict(counts=counts, moved=moved, received=received,
                volt_err=volt_err, agree=agree,
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


def fit_link(ranks) -> dict:
    """``H100_GLOO_STAGED``'s staging terms and ``H100_SXM``'s coordination
    overhead from the ``[vit]`` forwards (both ranks' medians averaged).
    Per forward the cost model charges ``calls · staging_fixed_ms + 2 ·
    received bytes / staging_bw_base`` (every received byte staged device →
    host → device); the ``voltage`` and ``prism`` forwards give two such
    equations in the two unknowns, solved exactly when that gives both
    terms >= 0, else by the least squared relative error with one term at
    0 (a zero byte term reads as an unbounded rate).  The coordination
    overhead is the ``prism`` forward's wall less its staged collectives
    less the ``local`` forward over P."""
    import numpy as np
    keys = ranks[0]["keys"]
    local = next(k for k in keys if k == "local")
    volt = next(k for k in keys if k.startswith("voltage"))
    prism = next(k for k in keys if k.startswith("prism"))

    def mean(key, i):
        return statistics.mean(r["times"][key][i] for r in ranks)
    A = np.asarray([(ranks[0]["times"][k][2], 2 * ranks[0]["received"][k])
                    for k in (volt, prism)], float)
    y = np.asarray([mean(volt, 1), mean(prism, 1)])
    x = np.linalg.solve(A, y)
    if (x < 0).any():                     # one term alone, relative LSQ
        cands = []
        for col in range(2):
            a = A[:, col] / y
            c = np.zeros(2)
            c[col] = a.sum() / (a * a).sum()
            cands.append(c)
        x = min(cands, key=lambda c: float(np.sum(((A @ c - y) / y) ** 2)))
    fixed_ms, ms_per_byte = (float(v) for v in x)
    coord = mean(prism, 0) - mean(prism, 1) - mean(local, 0) / VIT_P
    return dict(staging_fixed_ms=fixed_ms,
                staging_bw_base=1e3 / ms_per_byte if ms_per_byte else
                float("inf"),
                coord_overhead_ms=coord,
                received={k: ranks[0]["received"][k] for k in (volt, prism)})


def phase_vit(card: str) -> dict:
    """ViT-B/16 at full width across 2 ranks on the one card, and the fit
    of the staged link → launch totals of the main-path forwards, summed
    over the ranks."""
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
    from repro_torch.profiling import H100_GLOO_STAGED, H100_SXM
    fit = fit_link(ranks)
    got = ", ".join(f"{k} {b / 1e6:.3f} MB"
                    for k, b in fit["received"].items())
    print(f"[fit] H100_GLOO_STAGED from this run's voltage and prism "
          f"forwards ({got} received per rank, payload and meta): "
          f"staging_fixed_ms "
          f"{fit['staging_fixed_ms']:.3f}, staging_bw_base "
          f"{fit['staging_bw_base'] / 1e6:.1f} MB/s; H100_SXM "
          f"coord_overhead_ms {fit['coord_overhead_ms']:.2f}; the presets "
          f"hold {H100_GLOO_STAGED.staging_fixed_ms:.3f} ms, "
          f"{H100_GLOO_STAGED.staging_bw_base / 1e6:.1f} MB/s, "
          f"{H100_SXM.coord_overhead_ms:.2f} ms [{card}]", flush=True)
    prism = next(k for k in r0["keys"] if k.startswith("prism"))
    return {name: sum(r["counts"][prism][i] for r in ranks)
            for i, name in enumerate(("segment_means", "prism_attention"))}


# ---------------------------------------------------------------------------
# phase 8: llama3.2-1b across 2 ranks on the card
# ---------------------------------------------------------------------------

def _timed(fn, group):
    """(result, host ms, staged-collective ms, calls, merge bytes) of one
    call, the card synchronised around it."""
    import torch
    group.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    st = group.stats
    return (out, (time.perf_counter() - t0) * 1e3, st.seconds * 1e3,
            st.calls, st.merge_bytes)


def _lm_rank(rank, world):
    """One rank of llama3.2-1b at full width on the shared card: the
    ``last_only`` forward under each plan (launches and gathered bytes
    asserted), greedy ``generate`` under ``voltage`` and ``prism`` (flash-
    decode launches asserted, tokens equal on both ranks) and one
    ``dispatch`` of a partitioned plan."""
    import numpy as np
    import torch
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.api import generation as gen_api
    from repro_torch.core.seq_group import get_seq_group
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.prism_attention import prism_attention
    from repro_torch.kernels.segment_means import segment_means
    from repro_torch.models import transformer as tfm
    from repro_torch.transport import exchange_wire_bytes, plan_wire_bytes
    group = get_seq_group("seq")
    t0 = time.perf_counter()
    fwd_plans = {"local": ExecutionPlan.local(),
                 "voltage": ExecutionPlan.voltage(seq_shards=world),
                 "prism": ExecutionPlan.prism(L=LM_L, cr=LM_N / (LM_L * world),
                                              seq_shards=world)}
    gen_prism = ExecutionPlan.prism(L=GEN_L, cr=PROMPT_T / (GEN_L * world),
                                    seq_shards=world)
    session = InferenceSession.from_config(
        ARCH, reduced=False, device="cuda", seed=0,
        plans=[*fwd_plans.values(), gen_prism])
    cfg = session.cfg
    sums = torch.stack([leaf.double().sum() for leaf in
                        _leaves(session.params)]).cpu().numpy().tobytes()
    if group.broadcast_object(sums) != sums:
        raise AssertionError(f"rank {rank}: weights differ from rank 0's")
    build_s = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (LM_B, LM_N), generator=g,
                           device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (PROMPT_B, PROMPT_T),
                           generator=g, device="cuda")
    kv_width = 2 * cfg.n_kv_heads * cfg.hd          # K and V per token

    def forward(key):
        with torch.inference_mode():
            return tfm.forward_lm(session.params, {"tokens": tokens}, cfg,
                                  fwd_plans[key].to_exchange_config(),
                                  last_only=True)[0]
    for key in fwd_plans:                           # warm-up
        forward(key)
    fwd = {}
    last = {}
    for key, plan in fwd_plans.items():             # the main path
        segment_means.launches = prism_attention.launches = 0
        last[key], *_ = _timed(lambda: forward(key), group)
        counts = (segment_means.launches, prism_attention.launches)
        moved = group.stats.payload_bytes
        want = 0 if not plan.distributed else exchange_wire_bytes(
            plan.effective_codec, n_tokens=LM_N, d_model=kv_width,
            bytes_per_el=cfg.torch_dtype.itemsize, batch=LM_B, P=world,
            n_layers=cfg.n_layers, L=plan.L)
        if moved != want:
            raise AssertionError(f"rank {rank} {key}: gathered {moved} "
                                 f"payload bytes, transport accounting says "
                                 f"{want}")
        n = cfg.n_layers if plan.mode == "prism" else 0
        if counts != (n, n):
            raise AssertionError(f"rank {rank} {key}: (segment_means, "
                                 f"prism_attention) launches {counts}, want "
                                 f"{(n, n)}")
        if last[key].shape != (LM_B, 1, cfg.vocab_size) or not \
                torch.isfinite(last[key]).all():
            raise AssertionError(f"rank {rank} {key}: last logits "
                                 f"{tuple(last[key].shape)} not finite / "
                                 f"wrong")
        runs = [_timed(lambda: forward(key), group) for _ in range(5)]
        fwd[key] = dict(counts=counts, moved=moved,
                        modeled=plan_wire_bytes(plan, cfg, LM_B, LM_N),
                        ms=statistics.median(r[1] for r in runs),
                        staged_ms=statistics.median(r[2] for r in runs),
                        calls=runs[0][3])
    volt_err = ((last["voltage"] - last["local"]).abs().max()
                / last["local"].abs().max()).item()
    if not volt_err <= 5e-2:
        raise AssertionError(f"rank {rank}: voltage vs local last logits "
                             f"differ by {volt_err:.3e} of the largest > 5e-2")
    for key in ("voltage", "prism"):
        both = group.all_gather(last[key], kind="meta")
        if not torch.equal(both[0], both[1]):
            raise AssertionError(f"{key} last logits differ between ranks")

    gen = {}
    for key in ("local", "voltage", gen_prism.key):
        plan = session.plans[key]
        xcfg = plan.to_exchange_config()
        session.generate(prompt, 2, plan=plan)          # warm-up
        flash_decode.launches = 0                       # the main path
        out, w, *_ = _timed(
            lambda: session.generate(prompt, N_NEW, plan=plan), group)
        launches = flash_decode.launches

        # generate's own parts timed apart: the prefill, then the decode
        # steps (a difference of two generate walls drowns the steps in
        # the scan prefill's spread)
        def prefill():
            cache = tfm.init_decode_cache(cfg, PROMPT_B, PROMPT_T + N_NEW,
                                          device="cuda", xcfg=xcfg)
            with torch.inference_mode():
                return gen_api.prefill_prompt(
                    session.params, prompt, {}, cache, cfg, xcfg,
                    gen_api.resolve_prefill_mode(cfg, xcfg))
        (logits, cache), w1, s1, c1, _ = _timed(prefill, group)
        tok = gen_api.sample_token(logits, None)[:, 0:1]

        def decode():
            with torch.inference_mode():
                return gen_api.decode_scan(session.params, cache, tok,
                                           PROMPT_T, None, cfg, xcfg, 0.0,
                                           N_NEW - 1)[0]
        rest, wd, sd, cd, md = _timed(decode, group)
        if not torch.equal(torch.cat([tok, rest], dim=1), out):
            raise AssertionError(f"rank {rank} {key}: prefill and decode "
                                 f"timed apart drew other tokens than "
                                 f"generate")
        steps = (PROMPT_T if plan.mode == "prism" else 0) + N_NEW - 1
        if launches != steps * cfg.n_layers:
            raise AssertionError(f"rank {rank} {key}: flash_decode launched "
                                 f"{launches} times, want {steps} steps x "
                                 f"{cfg.n_layers} layers")
        if out.shape != (PROMPT_B, N_NEW) or not (
                (out >= 0) & (out < cfg.vocab_size)).all():
            raise AssertionError(f"rank {rank} {key}: bad tokens")
        if plan.distributed:
            if cd != (N_NEW - 1) * cfg.n_layers:
                raise AssertionError(f"rank {rank} {key}: {cd} staged "
                                     f"calls over {N_NEW - 1} decode steps, "
                                     f"want one a layer")
            both = group.all_gather(out, kind="meta")
            if not torch.equal(both[0], both[1]):
                raise AssertionError(f"{key}: the ranks drew different "
                                     f"tokens")
        gen[key] = dict(tokens=out.cpu().numpy(), launches=launches,
                        wall_s=w / 1e3, prefill_s=w1 / 1e3, prefill_calls=c1,
                        prefill_staged_s=s1 / 1e3,
                        decode_ms=wd / (N_NEW - 1),
                        staged_ms=sd / (N_NEW - 1),
                        calls=cd / (N_NEW - 1),
                        merge_bytes=md / (N_NEW - 1))
    for key in ("voltage", gen_prism.key):
        gen[key]["agree"] = float(np.mean(gen[key]["tokens"]
                                          == gen["local"]["tokens"]))

    # one dispatch of a partitioned plan: the policy may pick prism only
    routed = InferenceSession(cfg, session.params, plans=[gen_prism],
                              allow_modes=("prism",), device="cuda")
    routed.profile(backend="simulated")
    small = tokens[:1, :PROMPT_T]
    group.reset_stats()
    logits = routed.dispatch({"tokens": small})
    rec = routed.history[-1]
    if logits.shape != (1, PROMPT_T, cfg.vocab_size) or not torch.isfinite(
            logits).all():
        raise AssertionError(f"rank {rank}: dispatch logits "
                             f"{tuple(logits.shape)} not finite / wrong")
    dispatch = dict(key=rec.exec_key, wall_ms=rec.wall_ms,
                    staged_ms=group.stats.seconds * 1e3,
                    output_bytes=group.stats.output_bytes)
    picked = group.all_gather(torch.tensor(list(routed.plans).index(
        rec.exec_key)), kind="meta")
    if len(set(picked.tolist())) != 1:
        raise AssertionError(f"dispatch ran {picked.tolist()} on the ranks")
    return dict(fwd=fwd, gen=gen, volt_err=volt_err, dispatch=dispatch,
                build_s=build_s, prism_key=gen_prism.key,
                cfg=(cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.hd, cfg.vocab_size))


def phase_lm(card: str) -> dict:
    """llama3.2-1b at full width across 2 ranks on the one card → launch
    totals of the main path, summed over the ranks: flash-decode in the
    sharded decode, segment means and PRISM attention in the ``prism``
    forward."""
    from repro_torch.core.seq_group import spawn
    t0 = time.perf_counter()
    ranks = spawn(_lm_rank, LM_P, timeout=RANK_TIMEOUT_S)
    r0, r1 = ranks
    L_, d, H, Hk, hd, V = r0["cfg"]
    print(f"[lm] {ARCH} full width ({L_} layers, d {d}, {H}/{Hk} heads, dh "
          f"{hd}, vocab {V}, bf16, random weights from seed 0, equal on both"
          f" ranks) on {LM_P} ranks sharing the card, gloo staged through "
          f"host memory; {time.perf_counter() - t0:.1f} s with rank "
          f"start-up", flush=True)
    for key, f in r0["fwd"].items():
        sm, pa = f["counts"]
        print(f"[lm] forward_lm(last_only) {key}: B={LM_B} N={LM_N}, per "
              f"rank: segment_means {sm}, prism_attention {pa} launches; "
              f"gathered {f['moved'] / 1e6:.3f} MB (= transport accounting "
              f"of K and V; plan_wire_bytes models {f['modeled'] / 1e6:.3f} "
              f"MB at d_model a token); forward {f['ms']:.2f} ms (rank 1: "
              f"{r1['fwd'][key]['ms']:.2f} ms), staged collectives "
              f"{f['staged_ms']:.2f} ms of it in {f['calls']} calls (median "
              f"of 5) [{card}]", flush=True)
    print(f"[lm] voltage vs local last logits: max |diff| "
          f"{r0['volt_err']:.2e} of the largest (tol 5e-2); voltage and "
          f"prism last logits equal on both ranks", flush=True)
    for key, gn in r0["gen"].items():
        agree = (f"; agreement with local tokens {gn['agree']:.0%}"
                 if "agree" in gn else "")
        print(f"[lm] generate {key}: [{PROMPT_B}, {PROMPT_T}] prompt + "
              f"{N_NEW} greedy tokens in {gn['wall_s']:.3f} s; timed apart:"
              f" prefill {gn['prefill_s']:.3f} s "
              f"({gn['prefill_calls']} staged calls, "
              f"{gn['prefill_staged_s']:.3f} s); decode "
              f"{gn['decode_ms']:.2f} ms/step (rank 1: "
              f"{r1['gen'][key]['decode_ms']:.2f}), staged "
              f"{gn['staged_ms']:.2f} ms in {gn['calls']:.0f} calls and "
              f"{gn['merge_bytes'] / 1e3:.1f} kB of merge partials a step; "
              f"flash_decode launches {gn['launches']} per rank"
              f"{agree} [{card}]", flush=True)
    dp = r0["dispatch"]
    print(f"[lm] dispatch of tokens [1, {PROMPT_T}] ran {dp['key']!r} on "
          f"both ranks: {dp['wall_ms']:.1f} ms, staged {dp['staged_ms']:.1f}"
          f" ms, global logits gather {dp['output_bytes'] / 1e6:.2f} MB "
          f"received per rank [{card}]", flush=True)
    sharded = ("voltage", r0["prism_key"])
    return {"flash_decode": sum(r["gen"][k]["launches"] for r in ranks
                                for k in sharded),
            "segment_means": sum(r["fwd"]["prism"]["counts"][0]
                                 for r in ranks),
            "prism_attention": sum(r["fwd"]["prism"]["counts"][1]
                                   for r in ranks)}


# ---------------------------------------------------------------------------
# phase 11: gemma2-27b across 4 ranks on the card
# ---------------------------------------------------------------------------

GEMMA_LAYERS = 2              # one local/global pair: 4 ranks share 80 GB


def _gemma_rank(rank, world):
    """One rank of gemma2-27b at full width, cut to one local/global pair,
    on the shared card: the ``last_only`` forward of [1, 8192] under
    ``local``, ``voltage`` and ``prism(L=16)`` (the windowed layer's halo,
    n_halo 2 of P − 1 = 3, and the global layer's means; launches and
    bytes by kind asserted), and greedy ``generate`` of the same prompt +
    GEMMA_NEW under ``voltage`` (the sharded windowed decode: flash-decode
    launches asserted, the same tokens on every rank), beside rank 0's
    one-rank ``local`` run of the same weights."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.configs import get_config
    from repro_torch.core.seq_group import get_seq_group
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.prism_attention import prism_attention
    from repro_torch.kernels.segment_means import segment_means
    from repro_torch.models import registry
    from repro_torch.models import transformer as tfm
    group = get_seq_group("seq")
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(GEMMA), n_layers=GEMMA_LAYERS)
    params = registry.init_params(cfg, seed=0, device="cuda")
    # f64 sums in slices: the embedding whole in f64 would be 9.4 GB a rank
    sums = torch.stack([part.double().sum() for leaf in _leaves(params)
                        for part in leaf.reshape(-1).split(1 << 26)]
                       ).cpu().numpy().tobytes()
    if group.broadcast_object(sums) != sums:
        raise AssertionError(f"rank {rank}: weights differ from rank 0's")
    plans = {"local": ExecutionPlan.local(),
             "voltage": ExecutionPlan.voltage(seq_shards=world),
             "prism": ExecutionPlan.prism(
                 L=GEMMA_L, cr=GEMMA_N / (GEMMA_L * world),
                 seq_shards=world)}
    session = InferenceSession(cfg, params, device="cuda",
                               plans=list(plans.values()))
    build_s = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, GEMMA_N), generator=g,
                           device="cuda")
    Np = GEMMA_N // world
    n_halo = min(-(-cfg.window // Np), world - 1)
    item = cfg.torch_dtype.itemsize
    shard = 2 * Np * cfg.n_kv_heads * cfg.hd * item     # K and V
    means = (world - 1) * 2 * GEMMA_L * cfg.n_kv_heads * cfg.hd * item
    n_pairs = cfg.n_layers // 2
    want = {"local": (0, 0),
            "voltage": (2 * n_pairs * (world - 1) * shard, 2 * n_pairs + 1),
            "prism": (n_pairs * (min(rank, n_halo) * shard + means),
                      n_pairs * (n_halo + 1) + 1)}

    def forward(key):
        with torch.inference_mode():
            return tfm.forward_lm(session.params, {"tokens": tokens}, cfg,
                                  plans[key].to_exchange_config(),
                                  last_only=True)[0]
    for key in plans:                               # warm-up
        forward(key)
    fwd, last = {}, {}
    for key in plans:                               # the main path
        segment_means.launches = prism_attention.launches = 0
        last[key], *_ = _timed(lambda: forward(key), group)
        st = group.stats
        counts = (segment_means.launches, prism_attention.launches)
        moved = dict(payload=st.payload_bytes, meta=st.meta_bytes,
                     cache=st.cache_bytes, output=st.output_bytes)
        if (moved["payload"], st.calls) != want[key]:
            raise AssertionError(f"rank {rank} {key}: {moved['payload']} "
                                 f"payload bytes in {st.calls} calls, want "
                                 f"{want[key]}")
        n = n_pairs if key == "prism" else 0
        if counts != (n, n):
            raise AssertionError(f"rank {rank} {key}: (segment_means, "
                                 f"prism_attention) launches {counts}, want "
                                 f"{(n, n)}")
        if last[key].shape != (1, 1, cfg.vocab_size) or not \
                torch.isfinite(last[key]).all():
            raise AssertionError(f"rank {rank} {key}: last logits not "
                                 f"finite / wrong shape")
        runs = [_timed(lambda: forward(key), group) for _ in range(3)]
        fwd[key] = dict(counts=counts, moved=moved, calls=runs[0][3],
                        ms=statistics.median(r[1] for r in runs),
                        staged_ms=statistics.median(r[2] for r in runs))
    err = {key: ((last[key] - last["local"]).abs().max()
                 / last["local"].abs().max()).item()
           for key in ("voltage", "prism")}
    if not err["voltage"] <= 5e-2:
        raise AssertionError(f"rank {rank}: voltage vs local last logits "
                             f"differ by {err['voltage']:.3e} of the largest")
    for key in ("voltage", "prism"):
        every = group.all_gather(last[key], kind="meta")
        if not all(torch.equal(every[0], e) for e in every[1:]):
            raise AssertionError(f"{key} last logits differ between ranks")

    # one windowed layer's exchange alone, no compute: its halo (n_halo
    # point-to-point calls) against the Voltage gather of the same K/V
    kv = torch.randn(2, 1, Np, cfg.n_kv_heads, cfg.hd, generator=g,
                     device="cuda").to(cfg.torch_dtype)

    def halo():
        for sft in range(n_halo, 0, -1):
            group.shift(kv, sft)
    alone = {}
    for name, fn in (("halo", halo), ("gather", lambda: group.all_gather(kv))):
        fn()                                        # warm-up
        runs = [_timed(fn, group) for _ in range(5)]
        alone[name] = dict(staged_ms=statistics.median(r[2] for r in runs),
                           calls=runs[0][3],
                           mb=group.stats.payload_bytes / 1e6)

    plan = plans["voltage"]
    flash_decode.launches = 0                       # the main path
    out, wall, staged, calls, merge = _timed(
        lambda: session.generate(tokens, GEMMA_NEW, plan=plan), group)
    launches = flash_decode.launches
    if launches != (GEMMA_NEW - 1) * cfg.n_layers:
        raise AssertionError(f"rank {rank}: flash_decode launched "
                             f"{launches} times, want {GEMMA_NEW - 1} steps "
                             f"x {cfg.n_layers} layers")
    every = group.all_gather(out, kind="meta")
    if not all(torch.equal(every[0], e) for e in every[1:]):
        raise AssertionError("gemma2 voltage generate: the ranks drew "
                             "different tokens")
    agree = None
    if rank == 0:
        local = session.generate(tokens, GEMMA_NEW, plan=plans["local"])
        agree = float((local == out).float().mean())
    return dict(fwd=fwd, err=err, build_s=build_s, n_halo=n_halo, alone=alone,
                gen=dict(tokens=out.cpu().numpy(), wall_s=wall / 1e3,
                         staged_s=staged / 1e3, calls=calls,
                         merge_bytes=merge, launches=launches, agree=agree),
                peak=torch.cuda.max_memory_allocated(),
                n_params=sum(t.numel() for t in _leaves(params)))


def phase_gemma(card: str) -> dict:
    """gemma2-27b at full width, cut to one local/global pair, across 4
    ranks sharing the card → launch totals of the main path, summed over
    the ranks: segment means and PRISM attention in the ``prism`` forward,
    flash-decode's windowed shard partial in the ``voltage`` generate."""
    import gc
    import torch
    from repro_torch.core.seq_group import spawn
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    ranks = spawn(_gemma_rank, GEMMA_P, timeout=RANK_TIMEOUT_S)
    r0 = ranks[0]
    print(f"[gemma] {GEMMA} full width cut to {GEMMA_LAYERS} of 46 layers "
          f"(one local/global pair; {r0['n_params'] / 1e9:.2f} B parameters "
          f"a rank, bf16, random from seed 0, equal on every rank) on "
          f"{GEMMA_P} ranks sharing the card, gloo staged through host "
          f"memory; Np {GEMMA_N // GEMMA_P}, n_halo {r0['n_halo']}; "
          f"{time.perf_counter() - t0:.1f} s with rank start-up; peak "
          f"allocated per rank " + ", ".join(
              f"{r['peak'] / 1e9:.2f}" for r in ranks) + f" GB (the parent "
          f"holds {held / 1e9:.2f} GB)", flush=True)
    for key in r0["fwd"]:
        for p, r in enumerate(ranks):
            f = r["fwd"][key]
            mb = {k: v / 1e6 for k, v in f["moved"].items()}
            share = f["staged_ms"] / f["ms"] if f["ms"] else 0.0
            print(f"[gemma] forward_lm(last_only) {key} B=1 N={GEMMA_N} "
                  f"rank {p}: {f['ms']:.2f} ms, staged {f['staged_ms']:.2f} "
                  f"ms ({share:.1%}) in {f['calls']} calls; received MB "
                  f"payload {mb['payload']:.3f}, meta {mb['meta']:.3f}, "
                  f"cache {mb['cache']:.3f}, output {mb['output']:.3f}; "
                  f"segment_means {f['counts'][0]}, prism_attention "
                  f"{f['counts'][1]} launches (median of 3) [{card}]",
                  flush=True)
    for p, r in enumerate(ranks):
        h, v = r["alone"]["halo"], r["alone"]["gather"]
        print(f"[gemma] one windowed layer's exchange alone (K and V [1, "
              f"{GEMMA_N // GEMMA_P}, 16, 128] bf16, no compute, median of "
              f"5) rank {p}: halo {h['staged_ms']:.2f} ms in {h['calls']} "
              f"point-to-point calls, {h['mb']:.3f} MB received; Voltage "
              f"gather {v['staged_ms']:.2f} ms in {v['calls']} call, "
              f"{v['mb']:.3f} MB [{card}]", flush=True)
    print(f"[gemma] last logits vs local, max |diff| of the largest: voltage"
          f" {r0['err']['voltage']:.2e} (tol 5e-2), prism "
          f"{r0['err']['prism']:.2e}; equal on every rank", flush=True)
    gn = r0["gen"]
    print(f"[gemma] generate voltage: [1, {GEMMA_N}] prompt + {GEMMA_NEW} "
          f"greedy tokens in {gn['wall_s']:.3f} s (rank 0; staged "
          f"{gn['staged_s']:.3f} s in {gn['calls']} calls, "
          f"{gn['merge_bytes'] / 1e3:.1f} kB of merge partials); "
          f"flash_decode launches {gn['launches']} per rank; tokens equal "
          f"on every rank; agreement with rank 0's one-rank local run "
          f"{gn['agree']:.0%} [{card}]", flush=True)
    return {"flash_decode": sum(r["gen"]["launches"] for r in ranks),
            "segment_means": sum(r["fwd"]["prism"]["counts"][0]
                                 for r in ranks),
            "prism_attention": sum(r["fwd"]["prism"]["counts"][1]
                                   for r in ranks)}


# ---------------------------------------------------------------------------
# phase 10: the codec exchanges and the ring executor across 2 ranks
# ---------------------------------------------------------------------------

# label → ExecutionPlan fields (P = 2 added); the ViT at L = 0 pads 197
# tokens to 198, Np 99, so the ring splits into 3 messages, not 2
CODEC_VIT = {"prism+int8": dict(mode="prism", codec="int8"),
             "prism+int4": dict(mode="prism", codec="int4"),
             "prism+topk": dict(mode="prism", codec="topk", codec_param=8),
             "voltage ring/1": dict(mode="voltage", overlap_chunks=1),
             "voltage ring/3": dict(mode="voltage", overlap_chunks=3)}
CODEC_LM = {"prism+int8": dict(mode="prism", codec="int8"),
            "voltage ring/1": dict(mode="voltage", overlap_chunks=1),
            "voltage ring/2": dict(mode="voltage", overlap_chunks=2)}
RING_GEN = "voltage ring/2"
# payload bytes a rank receives a forward at full width (K and V through
# the codec, every layer, from the one other rank)
CODEC_BYTES = {("vit", "prism+int8"): 15_510_528,
               ("vit", "prism+int4"): 8_211_456,
               ("vit", "prism+topk"): 10_948_608,
               ("vit", "voltage ring/1"): 29_196_288,
               ("vit", "voltage ring/3"): 29_196_288,
               ("lm", "prism+int8"): 17_825_792,
               ("lm", "voltage ring/1"): 33_554_432,
               ("lm", "voltage ring/2"): 33_554_432}


def _exchange_runs(group, fn, n: int) -> dict:
    """Median host ms of ``fn()`` over n runs (the card synchronised
    around each), its staged-collective ms, calls and received bytes."""
    import torch
    walls, staged = [], []
    for _ in range(n):
        group.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        staged.append(group.stats.seconds * 1e3)
    st = group.stats
    return dict(ms=statistics.median(walls), walls=walls,
                staged_ms=statistics.median(staged), calls=st.calls,
                payload=st.payload_bytes, meta=st.meta_bytes)


def _ring_rows(group, fn, n: int, ring: bool) -> dict:
    """``_exchange_runs`` of ``fn``; for a ring plan also ``serial_ms``,
    the median forward with the overlap taken away (``_SerialRing``),
    n/2 runs before the n timed ones and n/2 after."""
    if not ring:
        return _exchange_runs(group, fn, n)
    with _SerialRing():
        before = _exchange_runs(group, fn, n // 2)["walls"]
    row = _exchange_runs(group, fn, n)
    with _SerialRing():
        after = _exchange_runs(group, fn, n // 2)["walls"]
    row["serial_ms"] = statistics.median(before + after)
    return row


class _SerialRing:
    """Within the block, every ring transfer's wait starts only after the
    card has finished the work queued before it: the ring with its
    overlap taken away, to time what the overlap hides."""

    def __enter__(self):
        import torch
        from repro_torch.core.seq_group import RingTransfer
        self.wait = wait = RingTransfer.wait

        def serial(transfer):
            torch.cuda.synchronize()
            return wait(transfer)
        RingTransfer.wait = serial

    def __exit__(self, *exc):
        from repro_torch.core.seq_group import RingTransfer
        RingTransfer.wait = self.wait


def _codec_rank(rank, world):
    """One rank of the ``[codec]`` phase on the shared card: ViT-B/16 and
    llama3.2-1b at full width under the codec exchanges and the ring,
    payload bytes asserted against the codec accounting; the small f32 ViT
    under each codec on the card and on the CPU; greedy ``generate``
    under the ring (flash-decode launches counted)."""
    import numpy as np
    import torch
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.core.seq_group import get_seq_group
    from repro_torch.data import SyntheticImageDataset
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models import registry
    from repro_torch.transport import CodecSpec, get_codec
    group = get_seq_group("seq")

    def wire(plan, shape, dtype, layers):
        """Payload bytes a rank receives a forward: K and V a layer from
        every other rank, through the plan's codec."""
        codec = get_codec(plan.codec or "identity")
        spec = CodecSpec(L=plan.L, param=plan.codec_param)
        return 2 * codec.wire_bytes(shape, dtype, spec) * layers * (world - 1)

    # ViT-B/16, full width, bf16
    vit = InferenceSession.from_config(VIT, reduced=False, device="cuda",
                                       seed=0, plans=[ExecutionPlan.local()])
    cfg = vit.cfg
    fwd = registry.forward_fn(cfg)
    images, _ = SyntheticImageDataset(batch_size=VIT_B).sample()
    batch = {"images": torch.from_numpy(images).to(device="cuda")}
    plans = {k: ExecutionPlan(seq_axis="seq", seq_shards=world, **kw)
             for k, kw in CODEC_VIT.items()}

    def vit_fwd(plan):
        with torch.inference_mode():
            return fwd(vit.params, batch, plan.to_exchange_config())[0]
    local = vit.run("local", batch)
    Np = -(-VIT_TOKENS // world)
    shape = (VIT_B, Np, cfg.n_kv_heads, cfg.hd)
    rows = {}
    for key, plan in plans.items():
        vit_fwd(plan)                                   # warm-up
        group.reset_stats()
        logits = vit_fwd(plan)                          # the main path
        torch.cuda.synchronize()
        want = wire(plan, shape, cfg.torch_dtype, cfg.n_layers)
        if group.stats.payload_bytes != want:
            raise AssertionError(f"rank {rank} vit {key}: received "
                                 f"{group.stats.payload_bytes} payload bytes,"
                                 f" the codec accounting says {want}")
        if logits.shape != local.shape or not torch.isfinite(logits).all():
            raise AssertionError(f"rank {rank} vit {key}: logits "
                                 f"{tuple(logits.shape)} not finite / wrong")
        both = group.all_gather(logits, kind="meta")
        if not torch.equal(both[0], both[1]):
            raise AssertionError(f"vit {key}: logits differ between ranks")
        rows[("vit", key)] = dict(
            _ring_rows(group, lambda: vit_fwd(plan), 12,
                       plan.overlap_chunks > 0), want=want,
            agree=(logits.argmax(-1) == local.argmax(-1)).float().mean()
            .item())

    # the two staged transfers alone, no compute between: the gather that
    # the codec and Voltage exchanges call and the ring's shift, at the
    # bytes one ViT layer's K and V take through each codec and in full
    def per_call(fn, n=24):
        ms = []
        for _ in range(n):
            group.reset_stats()
            fn()
            ms.append(group.stats.seconds * 1e3)
        torch.cuda.synchronize()
        return statistics.median(ms)
    xfer = {}
    for nbytes in sorted({2 * get_codec(pl.codec or "identity").wire_bytes(
            shape, cfg.torch_dtype, CodecSpec(param=pl.codec_param))
            for pl in plans.values()} | {8 * VIT_B * Np * cfg.d_model}):
        buf = torch.randint(0, 255, (nbytes,), dtype=torch.uint8,
                            device="cuda")
        per_call(lambda: group.all_gather(buf), 4)      # warm-up
        xfer[nbytes] = (per_call(lambda: group.all_gather(buf)),
                        per_call(lambda: group.ring_shift(buf).wait()))

    # the small f32 ViT under each codec: the card against the CPU
    _exact_fp32()
    small_cfg, small_params, small_images = _small_vit()
    small_fwd = registry.forward_fn(small_cfg)
    small_err = {}
    for key, plan in plans.items():
        if plan.mode != "prism":
            continue
        xcfg = plan.to_exchange_config()
        with torch.inference_mode():
            out = {dev: small_fwd(_on(small_params, dev), {
                "images": torch.from_numpy(small_images).to(dev)}, xcfg)[0]
                .cpu()
                   for dev in ("cuda", "cpu")}
        small_err[key] = float((out["cuda"] - out["cpu"]).abs().max())
        if not small_err[key] <= 1e-4:
            raise AssertionError(f"rank {rank} small f32 ViT {key}: the card"
                                 f" vs the CPU differ by {small_err[key]:.3e}"
                                 f" > 1e-4")
    del vit, local
    torch.cuda.empty_cache()

    # llama3.2-1b, full width, bf16: forward_lm(last_only) and generate
    from repro_torch.models import transformer as tfm
    lm = InferenceSession.from_config(ARCH, reduced=False, device="cuda",
                                      seed=0, plans=[ExecutionPlan.local()])
    cfg = lm.cfg
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (LM_B, LM_N), generator=g,
                           device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (PROMPT_B, PROMPT_T),
                           generator=g, device="cuda")
    plans = {k: ExecutionPlan(seq_axis="seq", seq_shards=world, **kw)
             for k, kw in CODEC_LM.items()}

    def lm_fwd(plan):
        with torch.inference_mode():
            return tfm.forward_lm(lm.params, {"tokens": tokens}, cfg,
                                  plan.to_exchange_config(),
                                  last_only=True)[0]
    shape = (LM_B, LM_N // world, cfg.n_kv_heads, cfg.hd)
    for key, plan in plans.items():
        lm_fwd(plan)                                    # warm-up
        group.reset_stats()
        last = lm_fwd(plan)                             # the main path
        torch.cuda.synchronize()
        want = wire(plan, shape, cfg.torch_dtype, cfg.n_layers)
        if group.stats.payload_bytes != want:
            raise AssertionError(f"rank {rank} lm {key}: received "
                                 f"{group.stats.payload_bytes} payload bytes,"
                                 f" the codec accounting says {want}")
        if last.shape != (LM_B, 1, cfg.vocab_size) or not torch.isfinite(
                last).all():
            raise AssertionError(f"rank {rank} lm {key}: last logits "
                                 f"{tuple(last.shape)} not finite / wrong")
        rows[("lm", key)] = dict(_ring_rows(group, lambda: lm_fwd(plan), 6,
                                            plan.overlap_chunks > 0),
                                 want=want)
    plan = plans[RING_GEN]
    lm.generate(prompt, 2, plan=plan)                   # warm-up
    flash_decode.launches = 0                           # the main path
    group.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = lm.generate(prompt, N_NEW, plan=plan)
    torch.cuda.synchronize()
    gen = dict(s=time.perf_counter() - t0, launches=flash_decode.launches,
               calls=group.stats.calls, payload=group.stats.payload_bytes,
               merge=group.stats.merge_bytes,
               staged_ms=group.stats.seconds * 1e3)
    if gen["launches"] != (N_NEW - 1) * cfg.n_layers:
        raise AssertionError(f"rank {rank}: flash_decode launched "
                             f"{gen['launches']} times in the ring generate,"
                             f" want {(N_NEW - 1) * cfg.n_layers}")
    both = group.all_gather(out, kind="meta")
    if not torch.equal(both[0], both[1]):
        raise AssertionError("ring generate: the ranks drew different "
                             "tokens")
    local_out = lm.generate(prompt, N_NEW)
    gen["agree"] = float((out == local_out).float().mean().item())
    return dict(rows=rows, small_err=small_err, gen=gen, xfer=xfer,
                tokens=np.asarray(out.cpu()))


def phase_codec(card: str) -> int:
    """``[codec]``: the codec exchanges and the ring executor across 2
    ranks on the one card, and the codecs' decode throughput measured on
    it → flash-decode launches of the ring ``generate``, summed over the
    ranks."""
    from repro_torch.core.seq_group import spawn
    from repro_torch.transport import calibrate_codec_bws, get_codec
    bws = calibrate_codec_bws(["int8", "int4", "topk"], device="cuda",
                              iters=20, warmup=5)
    print("[codec] decode throughput measured on the card (f32 [4, 64, 256],"
          " median of 20, CUDA events): " + ", ".join(
              f"{n} {bw / 1e9:.2f} GB/s (modeled class constant "
              f"{type(get_codec(n)).decode_bw / 1e9:.2f} GB/s)"
              for n, bw in bws.items()) + f" [{card}]", flush=True)
    t0 = time.perf_counter()
    ranks = spawn(_codec_rank, VIT_P, timeout=RANK_TIMEOUT_S)
    r0, r1 = ranks
    print(f"[codec] ViT-B/16 B={VIT_B} and {ARCH} B={LM_B} N={LM_N} at full "
          f"width, bf16, random weights from seed 0, {VIT_P} ranks sharing "
          f"the card; {time.perf_counter() - t0:.1f} s with rank start-up",
          flush=True)
    for (model, key), row in r0["rows"].items():
        other = r1["rows"][(model, key)]
        if not row["payload"] == other["payload"] == CODEC_BYTES[(model,
                                                                  key)]:
            fail(f"[codec] {model} {key}: received {row['payload']} / "
                 f"{other['payload']} payload bytes, want "
                 f"{CODEC_BYTES[(model, key)]}")
        what = (f"ViT forward B={VIT_B}" if model == "vit" else
                f"{ARCH} forward_lm(last_only) B={LM_B} N={LM_N}")
        extra = (f"; argmax agreement with local {row['agree']:.0%}"
                 if "agree" in row else "")
        small = r0["small_err"].get(key) if model == "vit" else None
        extra += ("" if small is None else
                  f"; small f32 ViT card vs CPU max |logit diff| "
                  f"{max(small, r1['small_err'][key]):.2e} (tol 1e-4)")
        extra += ("" if "serial_ms" not in row else
                  f"; with the card synchronised before each ring wait (no "
                  f"overlap; median of {len(row['walls'])} around the timed "
                  f"runs) {row['serial_ms']:.2f} ms, so the overlap hides "
                  f"{row['serial_ms'] - row['ms']:.2f} ms")
        print(f"[codec] {what} {key}: forward {row['ms']:.2f} ms (rank 1: "
              f"{other['ms']:.2f} ms), staged {row['staged_ms']:.2f} ms "
              f"({row['staged_ms'] / row['ms']:.1%}) in {row['calls']} calls;"
              f" received per rank {row['payload']} payload bytes (= codec "
              f"accounting {row['want']}) + {row['meta']} meta bytes (median "
              f"of {len(row['walls'])}){extra} [{card}]",
              flush=True)
    import numpy as np
    sizes = sorted(r0["xfer"])
    fits = []
    for i, name in enumerate(("all_gather", "ring_shift")):
        ms = [statistics.mean(r["xfer"][n][i] for r in ranks) for n in sizes]
        slope, fixed = np.polyfit(np.asarray(sizes) / 1e6, ms, 1)
        fits.append(f"{name} " + ", ".join(
            f"{n / 1e6:.3f} MB {t:.2f}" for n, t in zip(sizes, ms))
            + f" ms (line: {fixed:.3f} ms + {slope:.3f} ms/MB)")
    print("[codec] one staged transfer alone, received per rank, median of "
          "24 a rank, both ranks averaged: " + "; ".join(fits)
          + f" [{card}]", flush=True)
    g0 = r0["gen"]
    print(f"[codec] generate {RING_GEN}: [{PROMPT_B}, {PROMPT_T}] prompt + "
          f"{N_NEW} greedy tokens in {g0['s']:.3f} s (rank 1: "
          f"{r1['gen']['s']:.3f} s), {g0['calls']} staged calls "
          f"({g0['staged_ms']:.1f} ms), ring prefill {g0['payload']} payload"
          f" bytes, {g0['merge']} merge bytes; flash_decode launches "
          f"{g0['launches']} per rank; tokens equal on both ranks; agreement "
          f"with local tokens {g0['agree']:.0%} [{card}]", flush=True)
    return sum(r["gen"]["launches"] for r in ranks)


# ---------------------------------------------------------------------------
# phase 12: the measured profile of partitioned plans across 2 ranks
# ---------------------------------------------------------------------------

SEQ_PROFILE_BATCHES = (1, 4, 8)
SEQ_PROFILE_BWS = (100.0, 400.0, 1000.0)
SEQ_PROFILE_ITERS, SEQ_PROFILE_WARMUP = 5, 2


def _profile_seq_rank(rank, world):
    """One rank of ViT-B/16 at full width: ``profile(backend="measured")``
    on the H100 presets over ``local``, ``voltage`` and ``prism(L=20)``,
    SPMD on every rank, with the segment-means and PRISM-attention
    launches counted around it."""
    import torch
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.kernels.prism_attention import prism_attention
    from repro_torch.kernels.segment_means import segment_means
    from repro_torch.profiling import (H100_GLOO_STAGED, H100_SXM,
                                       SweepSpec, get_backend)
    session = InferenceSession.from_config(
        VIT, reduced=False, device="cuda", seed=0,
        plans=[ExecutionPlan.local(),
               ExecutionPlan.voltage(seq_shards=world),
               ExecutionPlan.prism(L=VIT_L, cr=VIT_CR, seq_shards=world)])
    spec = SweepSpec(batches=SEQ_PROFILE_BATCHES, crs=(VIT_CR,),
                     bandwidths_mbps=SEQ_PROFILE_BWS)
    torch.cuda.synchronize()
    segment_means.launches = prism_attention.launches = 0     # main path
    t0 = time.perf_counter()
    pm = session.profile(spec, backend="measured", hardware=H100_SXM,
                         link=H100_GLOO_STAGED, iters=SEQ_PROFILE_ITERS,
                         warmup=SEQ_PROFILE_WARMUP)
    seconds = time.perf_counter() - t0
    counts = (segment_means.launches, prism_attention.launches)
    decisions = {B: session.decide(B) for B in (1, 8)}
    return dict(doc=json.dumps(pm.to_doc(), sort_keys=True), counts=counts,
                seconds=seconds, scale=get_backend("measured").last_scale,
                decisions={B: (d.mode, d.cr, d.codec, d.expected.total_ms)
                           for B, d in decisions.items()},
                n_layers=session.cfg.n_layers)


def phase_profile_seq(card: str) -> None:
    """The measured profile of ViT-B/16's partitioned plans on 2 ranks
    sharing the card: the same map and decisions on both ranks, and per
    plan and batch the charged rank's forward (the rank with the most
    compute), its measured staged ms and calls, the compute charged and
    the modeled staging at each swept bandwidth."""
    from repro_torch.core.seq_group import spawn
    t0 = time.perf_counter()
    ranks = spawn(_profile_seq_rank, VIT_P, timeout=RANK_TIMEOUT_S)
    r0 = ranks[0]
    if any(r["doc"] != r0["doc"] for r in ranks):
        raise AssertionError("[profile-seq] the ranks built different maps")
    if any(r["decisions"] != r0["decisions"] for r in ranks):
        raise AssertionError(f"[profile-seq] decisions differ: "
                             f"{[r['decisions'] for r in ranks]}")
    calls = (SEQ_PROFILE_WARMUP + SEQ_PROFILE_ITERS) * len(SEQ_PROFILE_BATCHES)
    want = (calls * r0["n_layers"],) * 2      # the prism plan's calls only
    for p, r in enumerate(ranks):
        if r["counts"] != want:
            raise AssertionError(f"[profile-seq] rank {p}: (segment_means, "
                                 f"prism_attention) launches {r['counts']} "
                                 f"during the profile, want {want}")
    entries = json.loads(r0["doc"])["entries"]
    print(f"[profile-seq] {VIT} full width on {VIT_P} ranks sharing the "
          f"card: measured profile on H100_SXM + H100_GLOO_STAGED of local, "
          f"voltage, prism(L={VIT_L}) at B {SEQ_PROFILE_BATCHES}, "
          f"{SEQ_PROFILE_ITERS} timed calls after {SEQ_PROFILE_WARMUP} a "
          f"plan and batch, in {r0['seconds']:.1f} s (rank 1 "
          f"{ranks[1]['seconds']:.1f} s); the same map on both ranks "
          f"({len(entries)} entries), anchor scale {r0['scale']:.4f}; "
          f"segment_means and prism_attention launches {r0['counts']} per "
          f"rank, all in the prism timing [{card}]", flush=True)
    for B in SEQ_PROFILE_BATCHES:
        local = entries[f"local|{B}|0|0"]
        print(f"[profile-seq] local B={B}: compute charged "
              f"{local['compute_ms']:.3f} ms (slowest rank's forward x "
              f"anchor scale) [{card}]", flush=True)
        for mode in ("voltage", "prism"):
            rows = {k: e for k, e in entries.items()
                    if k.startswith(f"{mode}|{B}|")}
            m = next(iter(rows.values()))["meta"]
            staging = ", ".join(
                f"{float(k.split('|')[3]):g} Mbps {e['staging_ms']:.3f} ms "
                f"(wire {e['comm_ms']:.3f} ms)"
                for k, e in sorted(rows.items(),
                                   key=lambda kv: float(kv[0].split("|")[3])))
            e0 = next(iter(rows.values()))
            print(f"[profile-seq] {mode} B={B}: charged rank's forward "
                  f"{m['forward_ms_measured']:.2f} ms, staged "
                  f"{m['staged_ms_measured']:.2f} ms in "
                  f"{m['staged_calls']:g} calls (measured, in the median "
                  f"call), "
                  f"compute charged {e0['compute_ms']:.3f} ms per rank "
                  f"(seq_group {m['seq_group']}, per_rank "
                  f"{m['per_rank']}); modeled staging {staging} "
                  f"[{card}]", flush=True)
    for B, (mode, cr, codec, total) in sorted(r0["decisions"].items()):
        print(f"[profile-seq] decide B={B} at 400 Mbps: {mode}"
              + (f"@{cr:g}" if cr else "") + (f"+{codec}" if codec else "")
              + f" ({total:.3f} ms expected) on both ranks", flush=True)
    print(f"[profile-seq] phase {time.perf_counter() - t0:.1f} s with rank "
          f"start-up", flush=True)


# ---------------------------------------------------------------------------
# phase 13: the fleet tier — in process and over the RPC wire
# ---------------------------------------------------------------------------

FLEET_REQUESTS, FLEET_PROMPT, FLEET_NEW = 24, 32, 16
# the reference launcher's 4 slots a worker, so a worker decodes a batch
FLEET_SLOTS, FLEET_CHUNK = 4, 8
# a batched bf16 row may round differently from its B 1 generate; where a
# completion diverges, the token it took at its first divergent step must
# lie within this many logits of the top of the B 1 logits there
FLEET_TIE_TOL = 0.125
RPC_REQUESTS, RPC_RATE = 16, 16.0
RPC_CHAOS = "kill:rpc-b@0.5;revive:rpc-b@1.5"


def _fleet_ref_tokens(session, comps, prompts) -> tuple:
    """Greedy tokens of each completion against ``session``'s B 1
    ``generate`` of its prompt under the plan that served it → (count of
    exact completions, ``{request: (first divergent step, logit gap)}``).
    At a completion's first divergent step the B 1 logits of its common
    prefix are taken; the gap is their top less the logit of the token
    the completion took there, and it must not exceed FLEET_TIE_TOL."""
    import numpy as np
    exact, div = 0, {}
    for rid, comp in comps.items():
        plan = session.plans[comp.plan_key]
        prompt = np.asarray(prompts[rid])
        want = session.generate(prompt[None], FLEET_NEW,
                                plan=plan).cpu().numpy()[0]
        got = np.asarray(comp.tokens)
        if got.shape != want.shape:
            raise AssertionError(f"request {rid}: {len(got)} tokens, want "
                                 f"{len(want)}")
        if np.array_equal(got, want):
            exact += 1
            continue
        t = int(np.argmax(got != want))
        ctx = np.concatenate([prompt, got[:t]])[None]
        *_, logits = session.prime_slot(
            ctx, total_len=len(prompt) + FLEET_NEW, plan=plan,
            with_logits=True)
        row = logits.float().reshape(-1)
        gap = float(row.max() - row[int(got[t])])
        if gap > FLEET_TIE_TOL:
            raise AssertionError(
                f"request {rid} ({comp.plan_key}): token {int(got[t])} at "
                f"step {t} is {gap:.4f} below the top of the B 1 logits "
                f"(tolerance {FLEET_TIE_TOL}); B 1 generate {want}, fleet "
                f"{got}")
        div[rid] = (t, gap)
    return exact, div


def _divergence(exact: int, n: int, div: dict) -> str:
    """A line's account of the completions against their B 1 generate."""
    if not div:
        return f"{exact}/{n} token-exact against"
    steps = sorted(t for t, _ in div.values())
    gap = max(g for _, g in div.values())
    return (f"{exact}/{n} token-exact and {len(div)} diverging at a near "
            f"tie (first divergent steps {steps}, largest gap {gap:.4f} "
            f"logits, tolerance {FLEET_TIE_TOL}) against")


def phase_fleet(card: str) -> int:
    """Two ``WorkerHandle``s of llama3.2-1b at full width behind a
    ``FleetRouter``, one failed after the first step; then two RPC worker
    subprocesses under a kill/revive chaos schedule → flash-decode
    launches of the in-process fleet."""
    import gc
    import os

    import numpy as np
    import torch
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.fleet import DeviceRegistry, FleetRouter, WorkerHandle
    from repro_torch.kernels.flash_decode import flash_decode
    t0 = time.perf_counter()

    def make():
        s = InferenceSession.from_config(
            ARCH, reduced=False, device="cuda", seed=0,
            plans=[ExecutionPlan.local(),
                   ExecutionPlan.prism_sim(L=4, cr=9.9)])
        s.profile(backend="simulated")
        return s

    s1, s2 = make(), make()
    for a, b in zip(_leaves(s1.params), _leaves(s2.params)):
        if not torch.equal(a, b):
            raise AssertionError("[fleet] two sessions from one seed hold "
                                 "different weights")
    max_len = FLEET_PROMPT + FLEET_NEW
    reg = DeviceRegistry(heartbeat_timeout_s=1e9)
    for name, s in (("w1", s1), ("w2", s2)):
        reg.add(WorkerHandle(name, s, n_slots=FLEET_SLOTS, chunk=FLEET_CHUNK,
                             max_len=max_len))
    router = FleetRouter(reg)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, s1.cfg.vocab_size, FLEET_PROMPT)
               for _ in range(FLEET_REQUESTS)]
    torch.cuda.synchronize()
    flash_decode.launches = 0                           # the main path
    t1 = time.perf_counter()
    placed = router.fanout(prompts, FLEET_NEW)
    if any(rec is None for _, rec in placed):
        raise AssertionError("[fleet] a request was shed at placement")
    router.step()
    reg.fail("w1")
    router.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = flash_decode.launches
    if launches <= 0:
        raise AssertionError("[fleet] no flash_decode launch in the fleet")
    comps = {i: router.completion_for(req.id)
             for i, (req, _) in enumerate(placed)}
    if any(c is None for c in comps.values()):
        raise AssertionError("[fleet] a request never completed")
    served_by = {router.placement_for(req.id)[-1].worker
                 for req, _ in placed}
    if served_by != {"w2"}:
        raise AssertionError(f"[fleet] served by {sorted(served_by)}, want "
                             f"the survivor w2 only")
    exact, div = _fleet_ref_tokens(s2, comps, prompts)
    snap = router.stats_snapshot()
    lats = [c.latency_ms for c in comps.values()]
    plans = sorted({c.plan_key for c in comps.values()})
    print(f"[fleet] in process: 2 WorkerHandles of {ARCH} full width, bf16,"
          f" weights from seed 0 equal on both, {FLEET_SLOTS} slots a "
          f"worker, chunk {FLEET_CHUNK}; {FLEET_REQUESTS} requests of "
          f"{FLEET_PROMPT} tokens + {FLEET_NEW} fanned out, w1 failed after "
          f"the first step: {FLEET_REQUESTS / wall:.2f} requests/s "
          f"({wall:.2f} s), latency p50 {np.percentile(lats, 50):.0f} ms "
          f"p99 {np.percentile(lats, 99):.0f} ms; routed {snap['routed']}, "
          f"rerouted {snap['rerouted']}, dead {snap['dead']}; plans {plans};"
          f" {_divergence(exact, FLEET_REQUESTS, div)} the survivor's B 1"
          f" generate; flash_decode launches {launches} [{card}]",
          flush=True)
    del reg, router, s1, s2
    gc.collect()
    torch.cuda.empty_cache()
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p])
    _phase_fleet_rpc(card)
    print(f"[fleet] phase {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def _phase_fleet_rpc(card: str) -> None:
    """Two ``repro_torch.rpc.worker`` subprocesses (``--full --device
    cuda``) behind the router under ``RPC_CHAOS`` (kill = SIGKILL, revive
    = respawn): the kill reroutes and the revive readmits, every request
    once and held against one in-process session from the same seed as
    ``_fleet_ref_tokens`` says; shutdown closes both."""
    import gc

    import numpy as np
    import torch
    from repro_torch.chaos import ChaosController, FaultSchedule
    from repro_torch.fleet import DeviceRegistry, FleetRouter
    from repro_torch.rpc import RpcWorker
    from repro_torch.rpc.worker import build_session
    from repro_torch.runtime.fault import RetryPolicy
    from repro_torch.serving.queue import Request
    from repro_torch.transport.codecs import get_codec
    workers = []
    try:
        reg = DeviceRegistry(heartbeat_timeout_s=60.0)
        for name in ("rpc-a", "rpc-b"):
            t1 = time.perf_counter()
            w = RpcWorker(name, arch=ARCH, seed=0, n_slots=FLEET_SLOTS,
                          chunk=FLEET_CHUNK, max_len=FLEET_PROMPT + FLEET_NEW,
                          device="cuda", full=True,
                          retry=RetryPolicy(max_retries=3,
                                            backoff_base_s=0.05))
            workers.append(w)
            start_s = time.perf_counter() - t1
            reg.add(w)                  # calibrates on the worker's card
            if not w.codec_bws_measured:
                raise AssertionError(f"[fleet] rpc worker {name}: codec "
                                     f"calibration was not measured on its "
                                     f"card")
            bws = ", ".join(
                f"{c} {bw / 1e9:.3f} GB/s (modeled "
                f"{type(get_codec(c)).decode_bw / 1e9:.3f})"
                for c, bw in sorted(w.codec_bws.items()))
            print(f"[fleet] rpc worker {name}: pid {w.proc.pid}, ready and "
                  f"profiled in {start_s:.1f} s (spawn, CUDA init, weights, "
                  f"simulated profile); codec decode measured on its card "
                  f"({'measured' if w.codec_bws_measured else 'estimated'}"
                  f"): {bws} [{card}]", flush=True)
        router = FleetRouter(reg, retry=RetryPolicy(max_retries=3))
        rng = np.random.RandomState(1)
        arrivals = np.cumsum(rng.exponential(1.0 / RPC_RATE, RPC_REQUESTS))
        prompts = [rng.randint(0, 64, FLEET_PROMPT)
                   for _ in range(RPC_REQUESTS)]
        reqs = [Request(prompt=p, n_new=FLEET_NEW, seed=i,
                        arrival_ts=float(arrivals[i]))
                for i, p in enumerate(prompts)]
        chaos = ChaosController(reg, FaultSchedule.parse(RPC_CHAOS),
                                router=router)
        out = router.drive_real(reqs, events=chaos.events(), timeout_s=300.0)
        comps = out["completions"]
        ids = sorted(c.request_id for c in comps)
        if ids != sorted(r.id for r in reqs) or out["shed"]:
            raise AssertionError(f"[fleet] rpc: completions {ids} for "
                                 f"{sorted(r.id for r in reqs)} (shed "
                                 f"{[r.id for r in out['shed']]})")
        snap = router.stats_snapshot()
        if (snap["rerouted"] < 1 or snap["readmissions"] < 1
                or len(chaos.log) != 2):
            raise AssertionError(
                f"[fleet] rpc: the kill did not take effect: rerouted "
                f"{snap['rerouted']}, readmissions {snap['readmissions']}, "
                f"chaos log {chaos.log}")
        t1 = time.perf_counter()
        ref, _, _ = build_session(ARCH, seed=0, device="cuda", full=True)
        base = reqs[0].id
        exact, div = _fleet_ref_tokens(
            ref, {c.request_id - base: c for c in comps}, prompts)
        by_worker = {}
        for c in comps:
            by_worker[c.worker] = by_worker.get(c.worker, 0) + 1
        lats = [c.latency_ms for c in comps]
        print(f"[fleet] rpc: {RPC_REQUESTS} requests at {RPC_RATE:g}/s "
              f"under '{RPC_CHAOS}' (kill = SIGKILL, revive = respawn): "
              f"served once each in {out['makespan_s']:.2f} s, latency p50 "
              f"{np.percentile(lats, 50):.0f} ms p99 "
              f"{np.percentile(lats, 99):.0f} ms, by worker {by_worker}; "
              f"routed {snap['routed']}, rerouted {snap['rerouted']}, lost "
              f"{snap['lost']}, readmissions {snap['readmissions']}; chaos "
              f"log {len(chaos.log)} events; "
              f"{_divergence(exact, RPC_REQUESTS, div)} the B 1 generate of "
              f"an in-process session from seed 0 "
              f"(built and checked in {time.perf_counter() - t1:.1f} s) "
              f"[{card}]", flush=True)
        del ref
    finally:
        for w in workers:
            try:
                w.close()
            except Exception:
                w.kill_process()
        gc.collect()
        torch.cuda.empty_cache()
    alive = [w.name for w in workers
             if w.proc is not None and w.proc.poll() is None]
    if alive:
        raise AssertionError(f"[fleet] rpc workers still alive after "
                             f"shutdown: {alive}")
    print(f"[fleet] rpc shutdown: {len(workers)} workers closed", flush=True)


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
    import torch
    from repro_torch.kernels.flash_decode.kernel import attributes
    for paged in (False, True):
        for dtype, dh, group in ((torch.bfloat16, 64, 8),
                                 (torch.bfloat16, 128, 8),
                                 (torch.float32, 64, 4),
                                 (torch.float32, 64, 8),
                                 (torch.float32, 128, 4),
                                 (torch.float32, 128, 8)):
            a = attributes(paged, dh, dtype, group)
            print(f"[build] flash_decode{'_paged' if paged else ''} "
                  f"{str(dtype).split('.')[1]} dh={dh} group<={group}: "
                  f"{_resources(a)}", flush=True)
    from repro_torch.kernels.segment_means.kernel import \
        attributes as seg_attributes
    for dtype in (torch.bfloat16, torch.float32):
        print(f"[build] segment_means {str(dtype).split('.')[1]} (16-byte "
              f"lanes, masked): {_resources(seg_attributes(dtype))}",
              flush=True)
    from repro_torch.kernels.prism_attention.kernel import \
        attributes as prism_attributes
    for dtype, out_dtype, dh, warps in (
            (torch.bfloat16, torch.bfloat16, 64, 7),
            (torch.bfloat16, torch.float32, 64, 7),
            (torch.bfloat16, torch.bfloat16, 128, 8),
            (torch.bfloat16, torch.float32, 128, 8),
            (torch.float32, torch.float32, 64, 0),
            (torch.float32, torch.float32, 128, 0)):
        body = (f"{warps} + 1 warps" if dtype == torch.bfloat16
                else "CUDA-core body")
        print(f"[build] prism_attention {str(dtype).split('.')[1]} → "
              f"{str(out_dtype).split('.')[1]} dh={dh} ({body}): "
              f"{_resources(prism_attributes(dh, dtype, out_dtype, warps))}",
              flush=True)


def _resources(a: dict) -> str:
    return (f"{a['registers']} registers, {a['spill_bytes']} bytes spilled, "
            f"{a['smem_bytes']} bytes of shared memory per CTA, "
            f"{a['ctas_per_sm']} CTAs per SM")


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
    shard = phase_shard_partial()
    gemma_shard = phase_gemma_shard_partial()
    paged = phase_paged_kernel()
    exchange = phase_exchange_kernels()
    phase_small_reference()
    phase_small_serving()
    phase_small_vit_reference()
    phase_small_lm_reference()
    phase_small_gemma_reference()
    launches, session = phase_session(card)
    serve_dense, serve_paged = phase_serve(card, session)
    del session
    torch.cuda.empty_cache()
    vit_launches = phase_vit(card)
    lm_launches = phase_lm(card)
    lm_launches["flash_decode"] += phase_codec(card)
    gemma_launches = phase_gemma(card)
    phase_profile_seq(card)
    fleet_launches = phase_fleet(card)
    archs = {arch: phase_arch_session(card, arch)
             for arch, _, _ in DECODE_ARCHS}

    main_shape = timed[(PROMPT_B, PROMPT_T + N_NEW)]
    src = "src/repro_torch/kernels/{0}/csrc/{1}.cu"
    rows = (("flash_decode", "src/repro/kernels/flash_decode/kernel.py:61",
             launches + serve_dense + fleet_launches, main_shape),
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
    for arch, H, Hk in DECODE_ARCHS:        # their decode shapes
        kernels.append({
            "name": "flash_decode", "route": "cuda",
            "source": src.format("flash_decode", "flash_decode"),
            "replaces": rows[0][1], "launches": archs[arch]["launches"],
            "shape": f"{arch}: bf16 B={PROMPT_B} S={PROMPT_T + N_NEW} "
                     f"{H}/{Hk} heads dh=128"
                     + (" softcap=50 scale=1/12" if arch == GEMMA else ""),
            **{k: timed[(arch, PROMPT_T + N_NEW)][k] for k in keys}})
    gnp = GEMMA_N // GEMMA_P
    gemma_s = GEMMA_N + GEMMA_NEW
    for kname, n, t, shape in (
            ("flash_decode", archs[GEMMA]["long_launches"],
             timed[(GEMMA, "window")],
             f"{GEMMA} local layer at B 1: bf16 S={GEMMA_LONG + N_NEW} "
             f"window=4096 32/16 heads dh=128 softcap=50 scale=1/12; "
             f"launches: the whole B 1 generate, its "
             f"{archs[GEMMA]['n_layers'] // 2} local layers at this shape "
             f"and as many global layers at this S without a window"),
            ("flash_decode", gemma_launches["flash_decode"], gemma_shard,
             f"{GEMMA} windowed shard partial ({GEMMA_P} ranks): bf16 B=1 "
             f"Sp={gemma_s // GEMMA_P} of S={gemma_s}, rank 2, window=4096 "
             f"32/16 heads dh=128 softcap=50 scale=1/12"),
            ("segment_means", gemma_launches["segment_means"],
             exchange["segment_means_gemma"],
             f"{GEMMA} prism forward per rank ({GEMMA_P} ranks): K and V "
             f"bf16 [1, {gnp}, 16·128] L={GEMMA_L}"),
            ("prism_attention", gemma_launches["prism_attention"],
             exchange["prism_attention_gemma"],
             f"{GEMMA} prism forward per rank: bf16 [1, {gnp}] 32/16 heads "
             f"dh=128 causal softcap=50 scale=1/12 L={GEMMA_L} part "
             f"{GEMMA_P - 1}")):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": src.format(kname, kname),
            "replaces": {r[0]: r[1] for r in rows}[kname], "launches": n,
            "shape": shape, **{k: t[k] for k in keys}})
    lm_np = LM_N // LM_P
    for kname, replaces, t, shape in (
            ("flash_decode", rows[0][1], shard,
             f"{ARCH} shard partial (sharded decode, {LM_P} ranks): bf16 "
             f"B={PROMPT_B} Sp={(PROMPT_T + N_NEW) // LM_P} of "
             f"S={PROMPT_T + N_NEW}, offset {(PROMPT_T + N_NEW) // LM_P}, "
             f"{N_HEADS}/{N_KV} heads dh=64"),
            ("segment_means", rows[2][1], exchange["segment_means_lm"],
             f"{ARCH} prism forward per rank: K and V bf16 [{LM_B}, {lm_np}, "
             f"{N_KV}·64] L={LM_L}"),
            ("prism_attention", rows[3][1], exchange["prism_attention_lm"],
             f"{ARCH} prism forward per rank: bf16 [{LM_B}, {lm_np}] "
             f"{N_HEADS}/{N_KV} heads dh=64 causal L={LM_L} part 1")):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": src.format(kname, kname), "replaces": replaces,
            "launches": lm_launches[kname], "shape": shape,
            **{k: t[k] for k in keys}})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


if __name__ == "__main__":
    main()
