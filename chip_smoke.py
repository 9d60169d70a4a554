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
               attention, its (192, 128) widths for MLA included).
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
               heads, causal, softcap 50, scale 1/12, parts 0 and 3 of 4);
               and at the ``moe-seq`` phase's: deepseek-moe-16b's K+V
               [4, 256, 16·128] L 16 and causal PRISM attention 16/16 dh
               128 (parts 0 and 1), deepseek-v2-236b's latent [4, 256,
               512 + 64] L 16 (one input) and its PRISM attention with
               keys 192 and values 128, 128/128 heads (parts 0 and 1, f32,
               a fully masked row), each timed beside ``mean()`` or sdpa;
               flash-decode at deepseek-moe-16b's decode shape (B 4, S 48,
               16/16, dh 128).
   The cross-attention memories (``xattn kernels``): flash-decode over
               whisper-large-v3's 1500 frames (20/20 heads, dh 64) and
               llama-3.2-vision-11b's 1601 image tokens (32/8, dh 128) at
               B 4; the shard partial of rank 1 of 2 over the memory
               padded for L 16 (Mp 752 with 748 valid, Mp 816 with 785)
               and both blocks merged; the masked segment means of that
               block's K and V (held before the cast to bf16, the bf16
               means within one rounding step); the masked non-causal
               PRISM attention of a text partition q [4, 256] over the
               block (Nq ≠ Nk) and both blocks' means (parts 0 and 1),
               each timed beside sdpa or ``mean()``.
   hymba-1.5b's shapes (``ssm kernels``; 25/5 heads, dh 64: G = 5, the
               kernels' row tiles part full): flash-decode at B 4, S 48 in
               bf16 and f32 and with a fully masked row, and at the slot
               pool's B 2 step (each slot its own length) and B 1
               admission prefill; the shard
               partial of rank 1 of 2 in both types and every block
               merged; the segment means of K+V [4, 256, 5·64] L 16;
               causal PRISM attention q [4, 256, 25, 64] over 5 KV heads,
               parts 0 and 1; each timed beside sdpa or ``mean()``.
   Head width 16 (``dh16 kernels``; the reduced configs' width, every
               example's): flash-decode at the reduced llama's generate
               shape (B 2, S 16, 4/2 heads) in bf16 and f32, and at 8
               splits, fully masked rows, S 1, a window with softcap, MHA
               and G 8; the paged kernel at the reduced serving launcher's
               pool (B 8, ps 8) in both types, ps 5 with shared pages and
               a fully masked row; segment means of K+V [8, 64, 2·16] L 4
               and the reduced ViT's [4, 100, 4·16] L 20; PRISM attention
               at widths (16, 16) at the reduced prism train step's shape
               (q [8, 64, 4, 16], 2 KV heads, causal, parts 0 and 1, f32)
               and the reduced ViT's masked exchange (a row that sees no
               key); the main shapes timed beside sdpa or ``mean()``.
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
               gather), the halo's bytes asserted; a small f32
               deepseek-moe (dh 64) and deepseek-v2 (MLA at its widths:
               keys 128 + 64, values 128), in one process ``local``
               forward, 12 decode steps and greedy tokens on the card vs
               the CPU and the slot pool token-exact, and on 2 card ranks
               vs 2 CPU ranks ``voltage`` and ``prism`` forwards, aux
               loss, sharded decode steps (≤ 1e-4) and greedy tokens; a
               small f32 whisper and vision model (dh 64, a 13-token
               memory, the vision gates at 0.5), in one process ``local``
               and ``prism_sim`` forwards, 12 decode steps over the padded
               memory and greedy tokens on the card vs the CPU, and on 2
               card ranks vs 2 CPU ranks ``voltage`` and ``prism``
               forwards, sharded decode steps (≤ 1e-4) and greedy tokens;
               a small f32 hymba at G 5 (10/2 heads of 64, d = 640) and
               a two-group xLSTM, in
               one process the ``local`` forward, 12 decode steps, greedy
               tokens and the slot pool (a slot re-admitted) on the card
               vs the CPU and B 1 ``generate``, and on 2 card ranks vs 2
               CPU ranks ``voltage`` and ``prism`` forwards (the state
               hand-off), sharded decode steps (≤ 1e-4) and greedy
               tokens.
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
9. archs     — internlm2-1.8b, qwen1.5-32b, gemma2-27b and deepseek-moe-16b
               at full width
               (each with all its layers where they fit beside nothing
               else, else fewer, whole local/global pairs for gemma2, and
               at most ARCH_LAYERS: internlm2 12 of 24, qwen 8 of 64,
               gemma2 6 of 46, deepseek-moe 2 of 28, deepseek-v2 2 of
               60, as its lines
               say): the measured profile on the H100 presets at
               B 1, 8 and 32 with the anchor scale, decide and explain, and
               greedy generate under ``local`` with flash-decode launches
               asserted, decode time, device idle share and peak memory;
               gemma2 (no ``prism_sim`` plan: it raises on windowed layers,
               as in the JAX package) a second time at B 1 from a
               4608-token prompt, so its window masks every decode step;
               deepseek-moe-16b (cut to 2 of its 28 layers for time: its
               host loop was most of the phase; its prompts prefill by
               the decode loop, as ``auto`` keeps the moe family) also
               under ``prism_sim`` and served through the slot pool: 5
               greedy requests of 32 + 16 at 4 slots (one re-admitted),
               held against B 1 ``generate`` (near ties counted);
               deepseek-v2-236b cut to 4 of its 60 layers (the dense one
               and 3 of experts; ARCH_LAYERS, for time: 9 fit), ``local``
               generate, with no kernel on that path.
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
14. moe-seq  — deepseek-moe-16b (the dense layer + 3 of experts) and
               deepseek-v2-236b (the dense layer + 1 of experts) at full
               width on 2 ranks sharing the card: ``forward_lm(last_only)``
               B 4, N 512 under ``local`` (deepseek-moe), ``voltage`` (K/V,
               or the latent) and ``prism(L=16)`` (their means), per rank
               the forward ms, staged ms and share, calls (one a layer and
               one routing call a MoE layer) and payload and meta bytes,
               asserted against the shapes' count; greedy ``generate``
               [4, 32] + 16 under ``voltage`` (flash-decode launches
               asserted, the same tokens on both ranks, their agreement
               with ``local`` in bf16; the same weights in f32
               token-exact against ``local``).
15. audio, vlm — whisper-large-v3 (8 of its 32 encoder and 8 of its 32
               decoder layers) and llama-3.2-vision-11b (20 of its 40
               layers, 4 of them cross; XATTN_ARCH_CUT; every
               gate at 0.5: the reference's zero gate would erase the
               cross-attention) at full width: ``prefill_memory``
               (whisper's encoder over 1500 frames), the measured profile
               at B 1 and 4, one ``dispatch`` with the memory input, and
               greedy ``generate`` [4, 32] + 16 with the memory under
               ``local`` (whisper also ``prism_sim``), flash-decode
               launches of the self- and the cross-attention counted apart
               and asserted, decode ms a step, device idle share, peak
               memory.
16. xattn-seq — whisper cut to 4 encoder + 4 decoder layers and the vision
               model to one group (4 dense + 1 cross layer), full width,
               on 2 ranks sharing the card: ``forward_lm(last_only)`` B 4,
               N 512 with the memory under ``local``, ``voltage`` and
               ``prism(L=16)``, per rank the forward ms, staged ms and
               share, calls and payload and meta bytes (asserted against
               the shapes' count), the cross layers' segment-means and
               PRISM-attention launches apart; greedy ``generate`` [4, 32]
               + 16 under ``voltage`` (the memory's shard partials
               counted apart, the same tokens on both ranks, the same
               weights in f32 token-exact against ``local``).
17. hybrid, ssm — hymba-1.5b (4 of its 32 layers of attention beside a
               Mamba mixer) and xlstm-350m (1 of its 3 groups of 7 mLSTM
               + 1 sLSTM blocks; ARCH_LAYERS) at full width: the measured
               profile at
               B 1 and 4, decide, greedy ``generate`` [4, 32] + 16 under
               ``local`` and ``prism_sim`` (the decode-loop prefill),
               flash-decode launches asserted (hymba: every layer every
               step; xLSTM: none), decode ms a step, device idle share,
               the slot pool (3 requests, 2 slots: one re-admitted) held
               against B 1 ``generate``, peak memory.
18. ssm-seq  — hymba-1.5b cut to 4 layers and xlstm-350m to 1 group, full
               width, on 2 ranks sharing the card: ``forward_lm(last_only)``
               B 4, N 512 under ``local``, ``voltage`` and ``prism(L=16)``,
               every mixer starting from the state the rank before ended
               with (the chain of ``state`` messages), per rank the
               forward ms, staged ms and share, calls and the payload,
               meta and state bytes (asserted against the shapes' count),
               hymba's segment-means and PRISM-attention launches; greedy
               ``generate`` [4, 32] + 16 under ``voltage`` (no state
               moved, flash-decode launches asserted, the same tokens on
               both ranks, their agreement with ``local`` in bf16; the
               same weights in f32 token-exact against ``local``).
19. train-kernels — the segment-means and PRISM-attention autograd
               functions on the card (kernel forward, explicit PyTorch
               backward) against autograd of their plain versions on the
               same inputs and cotangent, f32 (≤ 1e-5 relative) and bf16
               (one rounding step at the largest value), at llama's
               ``prism`` train shape (B 4, Np 256, 32/8 heads, dh 64, L 16,
               causal, part 1) and ViT-B/16's (B 8, 100 tokens with 3
               pads, 12 heads, L 20, masked, counts); bf16 times of each
               forward kernel, its backward alone (beside its bound), the
               plain forward + backward and a yardstick's (sdpa over [K ‖
               means] with the bias as a mask; ``mean()``).
20. train-reference — a small f32 llama's summed gradient and 2 AdamW
               steps on the card against the same on the CPU: one process
               ``local``, and 2 card ranks against 2 CPU ranks under
               ``voltage`` and ``prism`` (loss and grad_norm ≤ 1e-5,
               gradients ≤ 1e-4 of each leaf's largest, params 99 %
               within 1e-5 and none past AdamW's sign-flip bound; the
               replicas bit-identical; under ``prism`` both kernels
               launched); then a ``Trainer`` on the card with a failure
               injected at step 3 resumes through ``FaultTolerantLoop``
               to the uninterrupted run's params and moments, bit for bit.
21. train    — llama3.2-1b at full width and depth (bf16 params, f32
               moments), B 4, N 512, ``local``, 5 AdamW steps through
               ``Trainer``, each layer rematerialised (the default), then
               without (``remat.disabled``): each step's ms and loss,
               tokens/s, the last step's device idle share
               (torch.profiler), peak memory, and the memory one more
               forward holds for its backward; beside the peak, the dry
               run's (``repro_torch.launch.dryrun``: the same step traced
               on the meta device in this process, counted, not
               measured).
22. train-seq — llama3.2-1b cut to 4 of 16 layers at full width on 2 ranks
               sharing the card, B 4, N 512, 2 steps each under
               ``voltage`` and ``prism(L=16)``, rematerialised: step ms,
               staged ms and share, the bytes received by kind (payload,
               meta, grad) asserted equal to the shapes (the recompute
               sends nothing), two segment-means and two PRISM-attention
               launches a layer a step under ``prism`` (the forward and
               its recompute), the loss at each step, the replicas
               bit-identical; then launch.train's reduced llama (4/2
               heads of 16) under ``prism(L=4)``, B 8, N 128, 2 steps:
               PRISM attention at widths (16, 16).
23. train-families — every family's partitioned training, small f32
               configs (heads of 64; MLA at (192, 128)), B 2, N 32, card
               ranks against CPU ranks (gradient ≤ 1e-4 of each leaf's
               largest, loss ≤ 1e-5, the ranks' sums bit-identical, both
               kernels launched under ``prism``): gemma2's halo on 4
               ranks; the ring, the int8/int4/topk codec gather, the moe
               routing call, MLA's latent, whisper, the vision model,
               hymba's and xLSTM's hand-off, the ViT's and ``last_only``'s
               logits broadcast on 2.
24. train-seq-families — gemma2-27b's local/global pair at full width
               (the vocabulary cut to 128000: 4 ranks' f32 logits of the
               full 256000 did not fit the card) on 4 ranks, B 1, N 8192
               (parts of 2048: the windowed layer's halo, 2 shifts), one
               forward + backward + gradient sum under ``prism(L=16)``
               with no optimizer; hymba-1.5b cut to 4 of 32 layers on 2
               ranks, B 4, N 512, 2 steps under ``voltage`` and
               ``prism(L=16)``: ms, staged ms and share, the bytes received
               by kind (payload, meta, state, grad: the halo's and the
               state's cotangents in it) asserted equal to the shapes,
               halo and hand-off calls, the kernels' launches (forward
               and recompute), peak memory, the ranks bit-identical.
25. mesh     — one (2, 2) spawn of launch.train's mesh path (ZeRO over
               ``data``, ``prism`` and ``local`` TP over ``model``, the
               re-mesh, ``build_decode_step``); while the ranks run, this
               process dry-runs (a)'s, (c)'s, (f)'s and (g)'s steps for
               each rank's coordinates on the meta device, and every
               rank's bytes by kind and calls of every step must equal the
               dry run's; its rank peaks are printed beside the measured
               ones.  (e)–(g) run the recurrent mixers and MLA's latents
               split by channel: hymba's Mamba, xlstm-350m's mLSTM by value
               channel and sLSTM by head, deepseek-v2's latent columns.
Between 4 and 5 (its number kept out of the others' way):
   examples  — the port's twins of the JAX package's four examples
               (``repro_torch.examples``: quickstart, serve_adaptive,
               train_lm, finetune_prism) in this process on the card at
               their reference configs, each printing its reference's
               lines and closing line; the reduced serving launcher
               through the dense slot pool and the paged pool; a reduced
               f32 llama's greedy tokens on the card against the CPU
               (``generate`` and the paged pool): flash-decode at head
               width 16 in both layouts and types, launches counted.

``python3 chip_smoke.py --only dh16,examples,train,train-seq,
train-seq-families [--remat on|off|both]`` runs those phases alone after
the build (the training phases rematerialised, without, or both in
turn), for measurements; it prints no kernels line.

The line before the last is a JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.  Any failure (a rank
that fails or hangs included) exits non-zero and prints no result.
"""
from __future__ import annotations

import concurrent.futures
import json
import multiprocessing
import os
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
MOE, MLA_ARCH = "deepseek-moe-16b", "deepseek-v2-236b"
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
                (GEMMA, 32, 16), (MOE, 16, 16))


def report_timed(case, label: str) -> dict:
    """Check, time and print one flash-decode case → its kernels-line
    numbers."""
    import torch
    errs = check_case(case)
    t = time_case(case)
    B, H, dh = case["q"].shape
    S, Hk = case["k"].shape[1], case["k"].shape[2]
    splits = splits_of(case["q"], Hk, S)
    cap = case["softcap"]
    extra = ("" if cap is None else f" softcap={cap:g}") + (
        "" if case["scale"] is None else f" scale={case['scale']:.6g}")
    f32 = case["q"].dtype == torch.float32
    print(f"[kernel] flash_decode {label} {'f32' if f32 else 'bf16'} B={B} "
          f"S={S} H={H} Hk={Hk} dh={dh}{extra}, splits {splits} "
          f"({B * Hk * splits} CTAs): err {err_text(errs)} (tol "
          f"{'1e-5' if f32 else '1e-3'}) | kernel {t['ms']*1e3:.2f} us, bound "
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
               shared=False, trash=True, masked_row=False, lens=None,
               heads=(N_HEADS, N_KV)):
    """Pools of P = B·MP pages plus the trash page (id P); ragged lengths
    (or ``lens``); each row's pages drawn from a permutation of the page
    ids (or in order), table entries past a row's pages on the trash page
    (or on other pages); ``shared`` points row 1's first pages at
    row 0's; ``heads`` = (query heads, KV heads)."""
    import torch
    from repro_torch.kernels.flash_decode import validity_bias
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)
    P = B * MP
    q = randn(B, heads[0], dh)
    k_pool = randn(P + 1, ps, heads[1], dh)
    v_pool = randn(P + 1, ps, heads[1], dh)
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
    splits = splits_of(args[0], args[1].shape[2], S)
    print(f"[kernel] flash_decode_paged {label}, splits {splits}: err "
          f"{err_text(errs)} (tol {tol:g})", flush=True)
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
                   note: str = "", breakdown: bool = True,
                   per_step: int = None):
    """Greedy ``generate`` of N_NEW tokens under plan ``key``, flash-decode
    launches counted around it and asserted = n_steps × ``per_step`` (the
    layers by default; 0 for MLA, whose decode is plain torch), tokens and
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
    # the prefill-dominated 1-token generate, the faster of 2: a host spike
    # only slows a run, and in one run it outweighed hymba's 15 decode steps
    w1 = min(timed_generate(session, prompt, 1, plan)[1] for _ in range(2))
    flash_decode.launches = 0
    out, w = timed_generate(session, prompt, N_NEW, plan)
    launches = flash_decode.launches
    per_step = cfg.n_layers if per_step is None else per_step
    want = n_steps * per_step
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
          f"launches {launches} (= {n_steps} steps x {per_step} layers);"
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
    activations: the moe family's first dense layers, then as many expert
    layers as fit beside the f32 draw of one expert stack (the weights are
    drawn in f32 and cast, one tensor at a time)."""
    import torch
    from repro_torch.models.registry import layer_weight_bytes
    d = cfg.d_model
    dense, moe = layer_weight_bytes(cfg)
    head = (cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
            * cfg.torch_dtype.itemsize + d * 4)
    room = torch.cuda.mem_get_info()[0] - head - headroom_bytes
    if cfg.moe is not None:
        e = cfg.moe
        room -= e.n_experts * d * e.d_ff_expert * 4
        fd = e.first_dense_layers
        return min(cfg.n_layers, fd + int((room - fd * dense) // moe))
    n = min(cfg.n_layers, int(room // dense))
    return n - n % 2 if cfg.local_global else n  # whole local/global pairs


def phase_arch_session(card: str, arch: str) -> dict:
    """``arch`` at full width, bf16, on the card (all its layers if they fit
    beside nothing else, at most ARCH_LAYERS[arch]): the measured profile
    on the H100 presets over three batches, decide and explain at B 1, 8
    and 32, and greedy
    ``generate`` under ``local`` with flash-decode launches asserted
    (gemma2 has no ``prism_sim`` plan: it raises on windowed layers, as in
    the JAX package; it generates a second time at B 1 from a
    GEMMA_LONG-token prompt, past its window).  The moe family prefills by
    the decode loop (as ``auto`` keeps it), so every prompt token is a
    decode step; deepseek-moe-16b also generates under ``prism_sim`` and
    serves through the slot pool (``serve_moe``); deepseek-v2's MLA
    decode launches no kernel, and it is asserted → (launches, layers
    driven, and gemma2's B 1 launches)."""
    import dataclasses
    import gc
    import torch
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models.registry import layer_weight_bytes
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    full = get_config(arch)
    n_layers = min(layers_that_fit(full), ARCH_LAYERS.get(arch, 10 ** 9))
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
    fam = ""
    if cfg.moe is not None:
        e = cfg.moe
        fam = (f"; {e.first_dense_layers} dense layer(s) of d_ff "
               f"{e.d_ff_dense}, then {e.n_experts} routed top-{e.top_k} + "
               f"{e.n_shared} shared experts of {e.d_ff_expert}, "
               f"{layer_weight_bytes(cfg)[1] / 1e9:.2f} GB a layer")
    if cfg.mla is not None:
        m = cfg.mla
        fam += (f"; MLA latent {m.kv_lora_rank} + {m.qk_rope_dim}, q rank "
                f"{m.q_lora_rank}, keys {m.qk_nope_dim + m.qk_rope_dim}, "
                f"values {m.v_head_dim}")
    print(f"[session] {arch} full width ({n_layers} of {full.n_layers} "
          f"layers, d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
          f"dh {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, qkv_bias "
          f"{cfg.qkv_bias}, kv_quant {cfg.kv_quant}, {cfg.dtype}{fam}; "
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
    steps = N_NEW - 1 + (PROMPT_T if cfg.moe is not None else 0)
    per_step = 0 if cfg.mla is not None else None
    launches, _ = drive_generate(session, prompt, "local", steps, card,
                                 note, per_step=per_step)
    if cfg.mla is not None:
        print(f"[generate] {arch}{note}: no kernel of the port runs on this "
              f"path on one card (MLA's absorbed decode is plain torch in "
              f"both packages, its experts plain matmuls; PRISM attention "
              f"runs only across ranks, [moe-seq])", flush=True)
    out = dict(launches=launches, n_layers=n_layers)
    if cfg.moe is not None and cfg.mla is None:
        key = next(k for k in session.plans if k != "local")
        out["launches"] += drive_generate(session, prompt, key, steps, card,
                                          note, breakdown=False)[0]
        out["launches"] += serve_moe(session, card, note)
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


def check_seg_kv_steps(label: str, case) -> float:
    """The K+V call (one launch) on bf16 inputs, each bf16 mean within one
    rounding step (2^-7 relative) of the plain version's (a long
    segment's mean on a rounding boundary may take either neighbour: the
    kernel multiplies by 1 / count where the plain version divides, and
    sums in another order), counts exact; and the same values in f32
    through the kernel's f32 instantiation within the f32 tolerance → max
    abs error of the bf16 means; raises past tolerance."""
    import torch
    from repro_torch.kernels.segment_means import (segment_means,
                                                   segment_means_kv,
                                                   segment_means_ref)
    x, L, mask = case
    y = torch.flip(x, dims=(2,)).contiguous()          # a second input
    before = segment_means.launches
    got, got_c = segment_means_kv(x, y, L, mask)
    got32, c32 = segment_means_kv(x.float(), y.float(), L, mask)
    torch.cuda.synchronize()
    if segment_means.launches != before + 2:
        raise AssertionError(f"segment_means K+V {label}: not one launch "
                             f"a call")
    err, worst = 0.0, 0.0
    for i, t in enumerate((x, y)):
        want, want_c = segment_means_ref(t, L, mask)
        want32, _ = segment_means_ref(t.float(), L, mask)
        err = max(err, rel_err(got32[i], want32))
        worst = max(worst, (got[i].float() - want.float()).abs().max().item())
        if not (torch.equal(got_c, want_c) and torch.equal(c32, want_c)):
            raise AssertionError(f"segment_means K+V {label}: counts differ")
        if not torch.isclose(got[i].float(), want.float(), rtol=2.0 ** -7,
                             atol=0.0).all():
            raise AssertionError(f"segment_means K+V {label}: bf16 means off "
                                 f"by more than one rounding step")
    if not err <= _tol(torch.float32):
        raise AssertionError(f"segment_means K+V {label}: f32 relative error "
                             f"{err:.3e} > {_tol(torch.float32):g}")
    print(f"[kernel] segment_means K+V {label}: bf16 means within one "
          f"rounding step, f32 rel err {err:.2e} (tol "
          f"{_tol(torch.float32):g}), counts exact, one launch", flush=True)
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


def time_seg_one(case) -> dict:
    """The one-input call at ``case``'s shape (the MLA exchange's latent
    means) beside the plain version and one ``mean()``."""
    import torch
    from repro_torch.kernels.segment_means import (segment_means,
                                                   segment_means_ref)
    x, L, mask = case
    B, N, D = x.shape
    copies = cold_copies((x, mask))
    moved = nbytes(x) + nbytes(mask) + B * L * D * x.element_size() + B * L * 4
    b_ms, b_by = roofline(moved, 2 * B * N * D, x.dtype)
    return {
        "ms": time_ms(lambda t, m: segment_means(t, L, m), copies),
        "plain_ms": time_ms(lambda t, m: segment_means_ref(t, L, m), copies),
        # yardstick only (the port never calls it)
        "library_ms": time_ms(
            lambda t, m: t.unflatten(1, (L, N // L)).mean(
                2, dtype=torch.float32), copies),
        "bound_ms": b_ms, "bound_by": b_by}


def prism_case(B, Np, H, Hk, dh, P, L, dtype, *, seed, causal=False,
               part=0, masked=True, softcap=None, dead_row=False,
               strided=False, scale=None, dv=None):
    """Local q/K/V of one partition, every partition's means, and the
    mean bias built as the exchange builds it (own partition hidden; with a
    mask, per-segment counts, one segment empty).  ``strided``: the means
    as the exchange hands them to the kernel, [B, P, L, Hk, dh] views of
    the gathered [P, 2, B, L, Hk, dh] payload; else flat [B, P·L, Hk,
    dh].  ``dv``: values (and their means) of that width, as the MLA
    exchange hands them over: the means [B, P, L, Hk, ·] expanded from the
    gathered latent, K and V apart."""
    import torch
    from repro_torch.kernels.prism_attention import build_mean_bias
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)
    q, k = randn(B, Np, H, dh), randn(B, Np, Hk, dh)
    v = randn(B, Np, Hk, dh if dv is None else dv)
    if dv is not None:
        km, vm = randn(B, P, L, Hk, dh), randn(B, P, L, Hk, dv)
        if not strided:
            km, vm = km.flatten(1, 2), vm.flatten(1, 2)
    elif strided:
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
    sees none).  2·H·(dh + dv) flops per (query, key it sees): under
    causal attention query i sees the unmasked local keys 0..i, not all of
    them."""
    import torch
    q, k, v, km, vm, bias, mask = case["args"]
    B, Nq, H, dh = q.shape
    Nk, Hk, M = k.shape[1], k.shape[2], bias.shape[1]
    dv = v.shape[3]
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
    moved = (nbytes(q) + B * Nq * H * dv * q.element_size()
             + nbytes(bias, mask)
             + int(keys.sum()) * Hk * (dh + dv) * k.element_size())
    return roofline(moved, 2 * H * (dh + dv) * int(per_q.sum()), q.dtype)


def _copy_prism_args(args):
    """A copy of PRISM-attention inputs, strided means laid out as the
    originals (views of one gathered [P, 2, B, L, Hk, dh] tensor)."""
    import torch
    q, k, v, km, vm, bias, mask = args
    if km.ndim == 5 and km.shape == vm.shape:
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


def check_prism(label: str, case, atol: float = 1e-6) -> float:
    """Kernel vs plain version on the f32 result before the final rounding
    to the inputs' type (relative max error within tolerance), and on the
    output as the serving path gets it (bf16: every element within one
    bf16 rounding step, 2^-7 relative, of the plain version's, plus
    ``atol`` of the largest output)."""
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
                         atol=atol * scale).all():
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
    out.update(moe_exchange_kernels())
    return out


def moe_exchange_kernels() -> dict:
    """The exchange kernels at the moe-seq phase's per-rank shapes (2
    ranks, B 4, Np 256 of N 512, L 16): deepseek-moe-16b's K and V means
    [4, 256, 16·128] and its causal PRISM attention (16/16 heads, dh 128);
    deepseek-v2-236b's latent means [4, 256, 512 + 64] (one input) and
    its PRISM attention over the expanded latent, keys 192 wide and values
    128, 128/128 heads (parts 0 and 1, an f32 case, a fully masked row)."""
    import torch
    from repro_torch.configs import get_config
    bf16, f32 = torch.bfloat16, torch.float32
    out = {}
    np_ = LM_N // LM_P
    c = get_config(MOE)
    H, Hk, dh = c.n_heads, c.n_kv_heads, c.hd
    seg = seg_case(LM_B, np_, (Hk, dh), LM_L, bf16, seed=40, masked=False)
    err = check_seg_kv(f"{MOE} bf16 2 x [{LM_B}, {np_}, {Hk}·{dh}] "
                       f"L={LM_L} unmasked", seg)
    out["segment_means_moe"] = t = dict(time_seg(seg), max_abs_err=err)
    print(f"[kernel] segment_means {MOE} prism shape, K and V in one "
          f"launch: kernel {t['ms']*1e3:.2f} us, bound "
          f"{t['bound_ms']*1e3:.2f} us ({t['bound_by']}), plain "
          f"{t['plain_ms']*1e3:.2f} us, mean() yardstick "
          f"{t['library_ms']*1e3:.2f} us", flush=True)
    g = dict(causal=True, masked=False, strided=True)
    check_prism(f"{MOE} causal {H}/{Hk} dh {dh} bf16 [{LM_B}, {np_}] "
                f"L={LM_L} P={LM_P} part 0",
                prism_case(LM_B, np_, H, Hk, dh, LM_P, LM_L, bf16, seed=41,
                           part=0, **g))
    pm = prism_case(LM_B, np_, H, Hk, dh, LM_P, LM_L, bf16, seed=42,
                    part=1, **g)
    err = check_prism(f"{MOE} part 1, means strided as gathered", pm)
    out["prism_attention_moe"] = t = dict(time_prism(pm), max_abs_err=err)
    print(f"[kernel] prism_attention {MOE} prism shape (part 1, causal): "
          f"kernel {t['ms']*1e3:.2f} us ({t['warps']} + 1 warps; 2 CTAs of "
          f"4 + 1: {t['split_ms']*1e3:.2f} us), bound "
          f"{t['bound_ms']*1e3:.2f} us ({t['bound_by']}), plain "
          f"{t['plain_ms']*1e3:.2f} us, sdpa yardstick "
          f"{t['library_ms']*1e3:.2f} us", flush=True)

    m = get_config(MLA_ARCH).mla
    width = m.kv_lora_rank + m.qk_rope_dim
    dqk, dv, H = m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim, \
        get_config(MLA_ARCH).n_heads
    lat = seg_case(LM_B, np_, (width,), LM_L, bf16, seed=43, masked=False)
    err = check_seg(f"{MLA_ARCH} latent bf16 [{LM_B}, {np_}, "
                    f"{m.kv_lora_rank} + {m.qk_rope_dim}] L={LM_L} unmasked",
                    lat)
    check_seg(f"{MLA_ARCH} latent f32 [{LM_B}, {np_}, {width}] L={LM_L} "
              f"masked", seg_case(LM_B, np_, (width,), LM_L, f32, seed=44))
    out["segment_means_mla"] = t = dict(time_seg_one(lat), max_abs_err=err)
    print(f"[kernel] segment_means {MLA_ARCH} latent (one input): kernel "
          f"{t['ms']*1e3:.2f} us, bound {t['bound_ms']*1e3:.2f} us "
          f"({t['bound_by']}), plain {t['plain_ms']*1e3:.2f} us, mean() "
          f"yardstick {t['library_ms']*1e3:.2f} us", flush=True)
    # the f32 results agree to ~2e-6 of the largest output at these widths,
    # as at the others; over 16.8 M outputs a near-zero one can round to
    # either side of a bf16 step, so the per-element check allows 1e-5 of
    # the largest output
    mla = dict(causal=True, masked=False, strided=True, dv=dv)
    check_prism(f"{MLA_ARCH} causal {H}/{H} dqk {dqk} dv {dv} bf16 "
                f"[{LM_B}, {np_}] L={LM_L} P={LM_P} part 0",
                prism_case(LM_B, np_, H, H, dqk, LM_P, LM_L, bf16, seed=45,
                           part=0, **mla), atol=1e-5)
    pm = prism_case(LM_B, np_, H, H, dqk, LM_P, LM_L, bf16, seed=46, part=1,
                    **mla)
    err = check_prism(f"{MLA_ARCH} part 1, means expanded from the gathered "
                      f"latent", pm, atol=1e-5)
    check_prism(f"{MLA_ARCH} f32 dqk {dqk} dv {dv} [1, {np_}] part 1",
                prism_case(1, np_, H, H, dqk, LM_P, LM_L, f32, seed=47,
                           part=1, **mla))
    check_prism(f"{MLA_ARCH} bf16 dqk {dqk} dv {dv} [2, 64] 16 heads, row 0 "
                f"fully masked",
                prism_case(2, 64, 16, 16, dqk, LM_P, 16, bf16, seed=48,
                           part=1, dead_row=True, dv=dv), atol=1e-5)
    out["prism_attention_mla"] = t = dict(time_prism(pm), max_abs_err=err)
    print(f"[kernel] prism_attention {MLA_ARCH} prism shape (part 1, causal,"
          f" dqk {dqk}, dv {dv}): kernel {t['ms']*1e3:.2f} us "
          f"({t['warps']} + 1 warps; 2 CTAs of 4 + 1: "
          f"{t['split_ms']*1e3:.2f} us), bound {t['bound_ms']*1e3:.2f} us "
          f"({t['bound_by']}), plain {t['plain_ms']*1e3:.2f} us, sdpa "
          f"yardstick {t['library_ms']*1e3:.2f} us (keys {dqk}, values {dv})",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phases 4 and 6: ViT across 2 ranks on the card
# ---------------------------------------------------------------------------

def _on(tree, device):
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on(v, device) for v in tree]
    return None if tree is None else tree.to(device)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return None if tree is None else tree.clone()


def _both_devices(fn, world: int, *args) -> dict:
    """``spawn(fn, world, *args, dev)`` on the card and on the CPU at once
    (two groups of ranks whose start-ups overlap) → {dev: ranks' results}."""
    from repro_torch.core.seq_group import spawn
    devs = ("cuda", "cpu")
    with concurrent.futures.ThreadPoolExecutor(len(devs)) as pool:
        return dict(zip(devs, pool.map(
            lambda dev: spawn(fn, world, *args, dev, timeout=RANK_TIMEOUT_S),
            devs)))


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


def _decode_steps(params, cfg, xcfg, steps, device, extras=None):
    """Logits of SMALL_LM_STEPS decode steps from a fresh cache (sharded
    under a partitioned ``xcfg``; audio and vlm: with the memory of
    ``extras`` filled in first) → [B, steps, V] on the CPU."""
    import torch
    from repro_torch.models import transformer as tfm
    cache = tfm.init_decode_cache(cfg, steps.shape[0], steps.shape[1],
                                  device=device, xcfg=xcfg)
    if extras:
        with torch.inference_mode():
            cache = tfm.prefill_memory(params, extras, cfg, xcfg, cache)
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
    ranks = _both_devices(_small_gemma_rank, GEMMA_P)
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
    elif tree is not None:
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


# ---------------------------------------------------------------------------
# the moe family: deepseek-moe-16b (GQA attention, routed experts) and
# deepseek-v2-236b (MLA attention, its latent exchange)
# ---------------------------------------------------------------------------

MOE_SERVE_REQUESTS, MOE_SERVE_SLOTS, MOE_SERVE_CHUNK = 5, 4, 8


def serve_moe(session, card: str, note: str) -> int:
    """deepseek-moe-16b served through the dense slot pool (``serve_pool``:
    MOE_SERVE_REQUESTS requests over MOE_SERVE_SLOTS slots, one slot
    re-admitted) → flash-decode launches."""
    return sum(serve_pool(session, card, note, MOE_SERVE_REQUESTS,
                          MOE_SERVE_SLOTS, MOE_SERVE_CHUNK).values())


def _small_moe(arch):
    """(reduced overrides, cfg, CPU params from seed 0, forward tokens,
    prompt, decode tokens) of the small f32 ``arch`` (d 256, 8 heads): GQA
    at dh 64 for deepseek-moe, MLA at deepseek-v2's widths (keys 128 + 64,
    values 128, latent 64 + 64) for deepseek-v2; the kernels take
    those."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MLACfg
    from repro_torch.models import registry
    reduced = dict(dtype="float32", n_heads=8, n_kv_heads=8, d_model=256)
    if arch == MOE:
        reduced["head_dim"] = 64
    else:
        reduced["mla"] = MLACfg(kv_lora_rank=64, q_lora_rank=96,
                                qk_nope_dim=128, qk_rope_dim=64,
                                v_head_dim=128)
    cfg = get_config(arch).reduced(**reduced)
    params = registry.init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(0)
    return (reduced, cfg, params,
            *(torch.randint(0, cfg.vocab_size, (SMALL_LM_B, n), generator=g)
              for n in (SMALL_LM_N, SMALL_LM_T0, SMALL_LM_STEPS)))


def _small_moe_rank(rank, world, arch, device):
    """One rank of the small f32 ``arch`` on ``device``: ``voltage`` and
    ``prism`` forward logits and aux loss, sharded decode steps, greedy
    tokens under both."""
    import torch
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.models import transformer as tfm
    _exact_fp32()
    reduced, cfg, params, tokens, prompt, steps = _small_moe(arch)
    plans = (ExecutionPlan.voltage(seq_shards=world),
             ExecutionPlan.prism(L=SMALL_LM_L, cr=1.0, seq_shards=world))
    session = InferenceSession.from_config(
        arch, reduced=reduced, params=_on(params, device), device=device,
        plans=list(plans))
    out = {}
    with torch.inference_mode():
        for p in plans:
            lg, aux = tfm.forward_lm(session.params,
                                     {"tokens": tokens.to(device)}, cfg,
                                     p.to_exchange_config())
            out[f"fwd/{p.mode}"] = lg.cpu()
            out[f"aux/{p.mode}"] = aux.cpu()
    out["decode"] = _decode_steps(session.params, cfg,
                                  plans[0].to_exchange_config(), steps,
                                  device)
    for p in plans:
        out[f"gen/{p.mode}"] = session.generate(prompt, SMALL_LM_NEW,
                                                plan=p).cpu()
    return {k: v.numpy() for k, v in out.items()}


def phase_small_moe_reference() -> None:
    """The small f32 deepseek-moe and deepseek-v2 on the card against the
    same weights on the CPU.  In one process: the ``local`` forward
    logits, 12 decode steps (flash-decode for deepseek-moe, the plain MLA
    decode for deepseek-v2) ≤ 1e-4, greedy tokens exact, and the dense
    slot pool serving token-exact.  On 2 ranks on the card against 2
    ranks on the CPU: ``voltage`` and ``prism`` forward logits and aux
    loss (segment means and PRISM attention: K and V at dh 64, or the
    latent and keys 192 / values 128), 12 sharded decode steps ≤ 1e-4,
    the ``voltage`` forward ≤ 1e-4 against the CPU's ``local``, greedy
    tokens exact under both."""
    import numpy as np
    import torch
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.api.generation import generate
    from repro_torch.core.exchange import ExchangeConfig
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import ServingRuntime
    local = ExchangeConfig()
    rng = np.random.RandomState(8)
    for arch in (MOE, MLA_ARCH):
        t0 = time.perf_counter()
        reduced, cfg, params, tokens, prompt, steps = _small_moe(arch)
        prompts = [rng.randint(1, cfg.vocab_size, n) for n in (5, 11, 3)]
        side = {}
        for dev in ("cpu", "cuda"):
            p = _on(params, dev)
            with torch.inference_mode():
                lg = tfm.forward_lm(p, {"tokens": tokens.to(dev)}, cfg,
                                    local)[0].cpu()
            session = InferenceSession.from_config(
                arch, reduced=reduced, params=p, device=dev,
                plans=[ExecutionPlan.local()])
            session.profile(backend="simulated")
            rt = ServingRuntime(session, n_slots=2, chunk=4, max_len=40)
            side[dev] = dict(
                fwd=lg, decode=_decode_steps(p, cfg, local, steps, dev),
                gen=generate(p, prompt.to(dev), SMALL_LM_NEW, cfg,
                             local).cpu(),
                served=_serve_all(rt, prompts, 9))
        cpu, gpu = side["cpu"], side["cuda"]
        worst = {k: (gpu[k] - cpu[k]).abs().max().item()
                 for k in ("fwd", "decode")}
        for key, err in worst.items():
            if not err <= 1e-4:
                raise AssertionError(f"small f32 {arch} local {key}: card vs "
                                     f"CPU differ by {err:.3e} > 1e-4")
        if not torch.equal(gpu["gen"], cpu["gen"]) or not all(
                np.array_equal(a, b)
                for a, b in zip(gpu["served"], cpu["served"])):
            raise AssertionError(f"small f32 {arch}: card tokens differ from "
                                 f"the CPU's (generate or slot pool)")
        ranks = _both_devices(_small_moe_rank, LM_P, arch)
        want = ranks["cpu"][0]
        seq = {}
        for key in ("fwd/voltage", "fwd/prism", "aux/voltage", "aux/prism",
                    "decode"):
            seq[key] = max(float(np.abs(r[key] - want[key]).max())
                           for r in ranks["cuda"])
            if not seq[key] <= 1e-4:
                raise AssertionError(f"small f32 {arch} {key}: {LM_P} ranks "
                                     f"on the card vs {LM_P} on the CPU "
                                     f"differ by {seq[key]:.3e} > 1e-4")
        volt = max(float(np.abs(r["fwd/voltage"] - cpu["fwd"].numpy()).max())
                   for r in ranks["cuda"])
        if not volt <= 1e-4:
            raise AssertionError(f"small f32 {arch}: voltage on the card vs "
                                 f"local on the CPU differ by {volt:.3e}")
        for key in ("gen/voltage", "gen/prism"):
            for r in ranks["cuda"] + ranks["cpu"]:
                if not np.array_equal(r[key], want[key]):
                    raise AssertionError(f"small f32 {arch} {key}: greedy "
                                         f"tokens differ across ranks/devices")
        if not np.array_equal(want["gen/voltage"], cpu["gen"].numpy()):
            raise AssertionError(f"small f32 {arch}: voltage tokens differ "
                                 f"from local's")
        attn = (f"MLA latent {cfg.mla.kv_lora_rank} + {cfg.mla.qk_rope_dim},"
                f" keys {cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim}, values "
                f"{cfg.mla.v_head_dim}" if cfg.mla is not None
                else f"dh {cfg.hd}")
        print(f"[reference] reduced f32 {arch} ({cfg.n_layers} layers, d "
              f"{cfg.d_model}, {cfg.n_heads} heads, {attn}, "
              f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}): local on "
              f"the card vs the CPU, max |logit diff| forward "
              f"{worst['fwd']:.2e}, {SMALL_LM_STEPS} decode steps "
              f"{worst['decode']:.2e} (tol 1e-4), greedy tokens and "
              f"{len(prompts)} slot-pool requests exact; {LM_P} ranks on the "
              f"card vs {LM_P} on the CPU: voltage forward "
              f"{seq['fwd/voltage']:.2e} (vs CPU local {volt:.2e}), "
              f"prism(L={SMALL_LM_L}) {seq['fwd/prism']:.2e}, aux loss "
              f"{max(seq['aux/voltage'], seq['aux/prism']):.2e}, "
              f"{SMALL_LM_STEPS} sharded decode steps {seq['decode']:.2e} "
              f"(tol 1e-4), greedy tokens exact under both; "
              f"{time.perf_counter() - t0:.1f} s with rank start-up",
              flush=True)


# per arch, the layers a rank holds in [moe-seq]: the first (dense) layer
# and 3 (deepseek-moe) or 1 (deepseek-v2) expert layers
MOE_SEQ = ((MOE, 4), (MLA_ARCH, 2))


def moe_seq_bytes(cfg, plan: str, P: int) -> dict:
    """What each rank's staged calls receive in one ``forward_lm`` of
    [LM_B, LM_N] under ``plan``, from shapes: the attention payload (K and
    V, or MLA's latent; in full under ``voltage``, L means a partition
    under ``prism``), and the routing call's meta (each MoE layer's
    counts [B, 1 group, E] and two sums [E], f32)."""
    if plan == "local":
        return dict(payload=0, meta=0, calls=0)
    Np = LM_N // P
    tokens = Np if plan == "voltage" else LM_L
    width = (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim
             if cfg.mla is not None else 2 * cfg.n_kv_heads * cfg.hd)
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    E = cfg.moe.n_experts
    return dict(payload=cfg.n_layers * (P - 1) * LM_B * tokens * width
                * cfg.torch_dtype.itemsize,
                meta=n_moe * (P - 1) * (LM_B + 2) * E * 4,
                calls=cfg.n_layers + n_moe + 1)      # + the logits broadcast


def _cast(tree, dtype):
    """``tree``'s floating-point tensors in ``dtype``, one at a time."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    if tree is None:
        return None
    return tree.to(dtype) if tree.is_floating_point() else tree


def _moe_seq_rank(rank, world):
    """One rank of deepseek-moe-16b and then deepseek-v2-236b at full
    width, cut to MOE_SEQ's layers, on the shared card: the ``last_only``
    forward of [LM_B, LM_N] under each plan (launches, payload and meta
    bytes and calls asserted), then greedy ``generate`` of [PROMPT_B,
    PROMPT_T] + N_NEW under ``voltage`` (flash-decode launches asserted,
    tokens equal on both ranks, their agreement with this rank's own
    ``local`` counted), and the same weights in f32 under ``voltage``
    token-exact against ``local``."""
    import dataclasses
    import gc
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
    res = {}
    for arch, n_layers in MOE_SEQ:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
        params = registry.init_params(cfg, seed=0, device="cuda")
        sums = torch.stack([leaf.double().sum() for leaf in
                            _leaves(params)]).cpu().numpy().tobytes()
        if group.broadcast_object(sums) != sums:
            raise AssertionError(f"rank {rank}: {arch} weights differ from "
                                 f"rank 0's")
        plans = {"local": ExecutionPlan.local(),
                 "voltage": ExecutionPlan.voltage(seq_shards=world),
                 "prism": ExecutionPlan.prism(
                     L=LM_L, cr=LM_N / (LM_L * world), seq_shards=world)}
        session = InferenceSession(cfg, params, device="cuda",
                                   plans=list(plans.values()))
        del params
        build_s = time.perf_counter() - t0
        g = torch.Generator(device="cuda").manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (LM_B, LM_N), generator=g,
                               device="cuda")
        prompt = torch.randint(0, cfg.vocab_size, (PROMPT_B, PROMPT_T),
                               generator=g, device="cuda")
        keys = ["voltage", "prism"] + ([] if cfg.mla is not None
                                       else ["local"])

        def forward(key):
            with torch.inference_mode():
                return tfm.forward_lm(session.params, {"tokens": tokens},
                                      cfg, plans[key].to_exchange_config(),
                                      last_only=True)[0]
        for key in keys:                                # warm-up
            forward(key)
        fwd = {}
        for key in keys:                                # the main path
            segment_means.launches = prism_attention.launches = 0
            last, *_ = _timed(lambda: forward(key), group)
            counts = (segment_means.launches, prism_attention.launches)
            st = group.stats
            got = dict(payload=st.payload_bytes, meta=st.meta_bytes,
                       calls=st.calls)
            want = moe_seq_bytes(cfg, key, world)
            if got != want:
                raise AssertionError(f"rank {rank} {arch} {key}: staged "
                                     f"{got}, the shapes give {want}")
            n = cfg.n_layers if key == "prism" else 0
            if counts != (n, n):
                raise AssertionError(f"rank {rank} {arch} {key}: "
                                     f"(segment_means, prism_attention) "
                                     f"launches {counts}, want {(n, n)}")
            if not torch.isfinite(last).all():
                raise AssertionError(f"rank {rank} {arch} {key}: last "
                                     f"logits not finite")
            both = group.all_gather(last, kind="meta")
            if not torch.equal(both[0], both[1]):
                raise AssertionError(f"{arch} {key}: last logits differ "
                                     f"between ranks")
            runs = [_timed(lambda: forward(key), group) for _ in range(3)]
            fwd[key] = dict(got, counts=counts,
                            ms=statistics.median(r[1] for r in runs),
                            staged_ms=statistics.median(r[2] for r in runs))
        want = session.generate(prompt, N_NEW, plan=plans["local"])
        session.generate(prompt, 2, plan=plans["voltage"])   # warm-up
        flash_decode.launches = 0                            # the main path
        out, w, sd, cd, md = _timed(
            lambda: session.generate(prompt, N_NEW, plan=plans["voltage"]),
            group)
        launches = flash_decode.launches
        steps = PROMPT_T + N_NEW - 1                 # decode-loop prefill
        per_step = 0 if cfg.mla is not None else cfg.n_layers
        if launches != steps * per_step:
            raise AssertionError(f"rank {rank} {arch} voltage generate: "
                                 f"flash_decode launched {launches} times, "
                                 f"want {steps} x {per_step}")
        both = group.all_gather(out, kind="meta")
        if not torch.equal(both[0], both[1]):
            raise AssertionError(f"{arch} voltage: the ranks drew different "
                                 f"tokens")
        agree = (out == want).float().mean().item()
        # in bf16 the sharded merge and the local kernel round apart, and a
        # router near a tie amplifies that into another expert; the same
        # weights in f32 must give local's tokens exactly
        peak = torch.cuda.max_memory_allocated()
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params32 = _cast(session.params, torch.float32)
        del session
        gc.collect()
        torch.cuda.empty_cache()
        s32 = InferenceSession(cfg32, params32, device="cuda",
                               plans=[plans["local"], plans["voltage"]])
        del params32
        want32 = s32.generate(prompt, N_NEW, plan=plans["local"])
        got32 = s32.generate(prompt, N_NEW, plan=plans["voltage"])
        if not torch.equal(got32, want32):
            raise AssertionError(f"rank {rank} {arch} f32: voltage tokens "
                                 f"{got32.tolist()} differ from local's "
                                 f"{want32.tolist()}")
        res[arch] = dict(fwd=fwd, build_s=build_s, gen_s=w / 1e3,
                         gen_staged_s=sd / 1e3, gen_calls=cd,
                         gen_merge=md, launches=launches, agree=agree,
                         peak=peak)
        del s32
        gc.collect()
        torch.cuda.empty_cache()
    return res


def phase_moe_seq(card: str) -> dict:
    """deepseek-moe-16b and deepseek-v2-236b at full width, cut to
    MOE_SEQ's layers, on 2 ranks sharing the card → launch totals of
    their ``prism`` forwards and ``voltage`` generate, summed over the
    ranks."""
    from repro_torch.configs import get_config
    from repro_torch.core.seq_group import spawn
    t0 = time.perf_counter()
    ranks = spawn(_moe_seq_rank, LM_P, timeout=RANK_TIMEOUT_S)
    out = {}
    for arch, n_layers in MOE_SEQ:
        full = get_config(arch)
        r0, r1 = ranks[0][arch], ranks[1][arch]
        attn = ("MLA, latent 512 + 64" if full.mla is not None
                else f"{full.n_heads}/{full.n_kv_heads} heads dh {full.hd}")
        print(f"[moe-seq] {arch} full width, {n_layers} of {full.n_layers} "
              f"layers (the dense one and {n_layers - 1} of experts), {attn},"
              f" bf16, random weights from seed 0, equal on both ranks; "
              f"{LM_P} ranks sharing the card, gloo staged through host "
              f"memory; built in {r0['build_s']:.1f} s, peak "
              f"{r0['peak'] / 1e9:.2f} GB a rank", flush=True)
        for key, f in r0["fwd"].items():
            share = f["staged_ms"] / f["ms"] if f["ms"] else 0.0
            sm, pa = f["counts"]
            print(f"[moe-seq] {arch} forward_lm(last_only) {key}: B={LM_B} "
                  f"N={LM_N}, per rank {f['ms']:.2f} ms (rank 1: "
                  f"{r1['fwd'][key]['ms']:.2f} ms), staged "
                  f"{f['staged_ms']:.2f} ms ({share:.1%}) in {f['calls']} "
                  f"calls; received {f['payload'] / 1e6:.4f} MB payload + "
                  f"{f['meta'] / 1e3:.2f} kB meta (the routing calls), "
                  f"= the shapes' count; segment_means {sm}, prism_attention"
                  f" {pa} launches (median of 3) [{card}]", flush=True)
        print(f"[moe-seq] {arch} generate voltage [{PROMPT_B}, {PROMPT_T}] +"
              f" {N_NEW}: {r0['gen_s']:.3f} s ({r0['gen_staged_s']:.3f} s "
              f"staged in {r0['gen_calls']} calls, "
              f"{r0['gen_merge'] / 1e3:.1f} kB of merge partials), the same "
              f"tokens on both ranks, {r0['agree']:.0%} of them local's in "
              f"bf16 (rank 1: {r1['agree']:.0%}); the same weights in f32 "
              f"token-exact against local on both ranks; flash_decode "
              f"launches {r0['launches']} a rank [{card}]", flush=True)
        tag = "mla" if full.mla is not None else "moe"
        pf = [r[arch]["fwd"]["prism"]["counts"] for r in ranks]
        out[f"segment_means_{tag}"] = sum(c[0] for c in pf)
        out[f"prism_attention_{tag}"] = sum(c[1] for c in pf)
        out[f"flash_decode_{tag}"] = sum(r[arch]["launches"] for r in ranks)
    m = get_config(MLA_ARCH)
    Np, H = LM_N // LM_P, m.n_heads
    dqk = m.mla.qk_nope_dim + m.mla.qk_rope_dim
    lat = m.mla.kv_lora_rank + m.mla.qk_rope_dim
    c = get_config(MOE)
    print(f"[moe-seq] bytes a layer a rank, from shapes: {MOE} voltage K+V "
          f"{LM_B} x {Np} x {c.n_kv_heads} x {c.hd} x 2 x 2 B = "
          f"{LM_B * Np * c.n_kv_heads * c.hd * 4 / 1e6:.2f} MB; {MLA_ARCH} "
          f"voltage latent {LM_B} x {Np} x {lat} x 2 B = "
          f"{LM_B * Np * lat * 2 / 1e6:.2f} MB, prism(L={LM_L}) {LM_B} x "
          f"{LM_L} x {lat} x 2 B = {LM_B * LM_L * lat * 2 / 1e3:.1f} kB; the "
          f"expanded K/V an exchange of K and V would ship instead: {LM_B} x"
          f" {Np} x {H} x ({dqk} + {m.mla.v_head_dim}) x 2 B = "
          f"{LM_B * Np * H * (dqk + m.mla.v_head_dim) * 2 / 1e6:.1f} MB; "
          f"{time.perf_counter() - t0:.1f} s with rank start-up", flush=True)
    return out


# ---------------------------------------------------------------------------
# the audio and vlm families: cross-attention to an encoder or image memory
# ---------------------------------------------------------------------------

WHISPER, VISION = "whisper-large-v3", "llama-3.2-vision-11b"
XATTN_ARCHS = (WHISPER, VISION)
# [arch]'s depth cuts (for time): whisper 8 + 8 of its 32 + 32
# layers (its encoder over 1500 frames is most of the phase), the vision
# model 20 of its 40 (4 of 8 cross layers)
XATTN_ARCH_CUT = {WHISPER: dict(encoder_layers=8, n_layers=8),
                  VISION: dict(n_layers=20)}
XATTN_GATE = 0.5        # every vlm gate: tanh(0) erases the cross-attention
# [xattn-seq]: whisper cut to 4 encoder + 4 decoder layers, the vision
# model to one group (4 dense layers and its cross layer), full width
XATTN_SEQ = ((WHISPER, dict(encoder_layers=4, n_layers=4)),
             (VISION, dict(n_layers=5)))
SMALL_XATTN_M = 13      # the small models' memory: padded to 16 under prism


def _memory_name(cfg) -> str:
    return "frames" if cfg.family == "audio" else "image_embeds"


def _memory_len(cfg) -> int:
    return cfg.encoder_seq if cfg.family == "audio" else cfg.image_tokens


def _memory_layers(cfg) -> tuple:
    """(layers that self-attend in the decoder, layers that attend the
    memory)."""
    if cfg.family == "audio":
        return cfg.n_layers, cfg.n_layers
    n = cfg.n_layers // cfg.cross_attn_every
    return cfg.n_layers - n, n


def _memory_shape(arch) -> tuple:
    """(heads, KV heads, dh, real memory length, the memory padded for
    PRISM over LM_P ranks at LM_L means) of ``arch``'s main path."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import pad_len
    c = get_config(arch)
    M0 = _memory_len(c)
    return c.n_heads, c.n_kv_heads, c.hd, M0, pad_len(M0, LM_P, LM_L)


def _open_gates(params) -> None:
    for cp in params.get("cross_layers", []):
        cp["gate"].fill_(XATTN_GATE)


class Inside:
    """Kernel launches made inside calls of ``module.<name>``, counted
    apart while the block runs (``counts``: kernel name → launches); the
    wrappers count every launch as always."""

    def __init__(self, module, name: str, kernels: dict):
        self.module, self.name, self.kernels = module, name, kernels
        self.counts = {k: 0 for k in kernels}

    def __enter__(self):
        real = self.real = getattr(self.module, self.name)

        def counted(*a, **kw):
            before = {k: obj.launches for k, obj in self.kernels.items()}
            out = real(*a, **kw)
            for k, obj in self.kernels.items():
                self.counts[k] += obj.launches - before[k]
            return out
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        return False


def mem_seg_case(Mp, D, pad, *, seed):
    """K of the memory's last block [PROMPT_B, Mp, D] bf16, LM_L means, its
    last ``pad`` positions padding."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(PROMPT_B, Mp, D, generator=g, device="cuda").to(
        torch.bfloat16)
    mask = (torch.arange(Mp, device="cuda") < Mp - pad)[None].repeat(
        PROMPT_B, 1)
    return x, LM_L, mask


def cross_prism_case(Nq, arch, part, *, seed):
    """PRISM cross-attention of text partition ``part`` of LM_P: q
    [PROMPT_B, Nq, H, dh] over its memory block (Mp keys under the block's
    mask, non-causal), both blocks' means strided as gathered ([B, P, L,
    Hk, dh] views of [P, 2, B, L, Hk, dh]) with the counts the padded
    memory gives."""
    import torch
    from repro_torch.kernels.prism_attention import build_mean_bias
    H, Hk, dh, M0, M = _memory_shape(arch)
    B, P, L, Mp = PROMPT_B, LM_P, LM_L, M // LM_P
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(
            torch.bfloat16)
    q, k, v = randn(B, Nq, H, dh), randn(B, Mp, Hk, dh), randn(B, Mp, Hk, dh)
    km, vm = randn(P, 2, B, L, Hk, dh).permute(1, 2, 0, 3, 4, 5)
    real = (torch.arange(M, device="cuda") < M0).reshape(P, L, -1)
    counts = real.sum(dim=-1).float()[None].repeat(B, 1, 1)
    mask = (torch.arange(Mp, device="cuda") + part * Mp < M0)[None].repeat(
        B, 1)
    bias = build_mean_bias(B, P, L, part, Mp // L, causal=False,
                           mean_counts=counts)
    return dict(args=(q, k, v, km, vm, bias, mask), causal=False,
                softcap=None, scale=None)


def _print_seg(label: str, t: dict) -> None:
    print(f"[kernel] segment_means {label}, K and V in one launch: kernel "
          f"{t['ms']*1e3:.2f} us, bound {t['bound_ms']*1e3:.2f} us "
          f"({t['bound_by']}), plain {t['plain_ms']*1e3:.2f} us, mean() "
          f"yardstick (unmasked) {t['library_ms']*1e3:.2f} us", flush=True)


def _print_prism(label: str, t: dict) -> None:
    print(f"[kernel] prism_attention {label}: kernel {t['ms']*1e3:.2f} us "
          f"({t['warps']} + 1 warps; 2 CTAs of 4 + 1: "
          f"{t['split_ms']*1e3:.2f} us), bound {t['bound_ms']*1e3:.2f} us "
          f"({t['bound_by']}), plain {t['plain_ms']*1e3:.2f} us, sdpa "
          f"yardstick {t['library_ms']*1e3:.2f} us", flush=True)


def _print_shard(label: str, t: dict, errs: dict) -> None:
    print(f"[kernel] flash_decode shard partial {label}: err "
          f"{err_text(errs)} (tol 1e-3) | kernel {t['ms']*1e3:.2f} us, bound "
          f"{t['bound_ms']*1e3:.2f} us ({t['bound_by']}), plain "
          f"{t['plain_ms']*1e3:.2f} us, sdpa yardstick over the block "
          f"{t['library_ms']*1e3:.2f} us", flush=True)


def phase_xattn_kernels() -> dict:
    """The kernels at every shape the memory models' main paths give them,
    bf16, each held against its plain version and timed beside its bound
    and the library yardstick.  Flash-decode, B 4: over whisper's 1500
    frames (20/20 heads, dh 64) and the vision model's 1601 image tokens
    (32/8, dh 128), every position valid, and the decoder's self-attention
    cache (S 48); the shard partial of rank 1 of 2 at offset Mp over the
    memory padded for P only (``voltage``: Mp 750 all valid, Mp 801 with
    800) and for L 16 as well (``prism``: Mp 752 with 748 valid, Mp 816
    with 785), both blocks merged against the dense kernel, and over the
    self-attention cache (Sp 24 of S 48).  Under ``prism`` across 2 ranks:
    the segment means of K and V in one launch over the memory block
    (masked, the last 4 or 31 positions padding), over whisper's encoder
    block (unmasked, [4, 752, 20·64]) and over the text partition ([4,
    256, Hk·dh]); PRISM attention, both partitions' means as gathered:
    the masked non-causal cross-attention of q [4, 256, H, dh] over the
    memory block (parts 0 and 1), whisper's encoder (non-causal, q = K =
    752, unmasked) and the decoder's causal self-attention (part 1)."""
    import torch
    from repro_torch.models.transformer import pad_len
    bf16 = torch.bfloat16
    S, np_ = PROMPT_T + N_NEW, LM_N // LM_P
    out = {}
    for i, arch in enumerate(XATTN_ARCHS):
        tag = ("whisper", "vision")[i]
        H, Hk, dh, M0, M = _memory_shape(arch)
        Mp, B = M // LM_P, PROMPT_B
        heads = f"{H}/{Hk} heads dh {dh}"
        out[f"decode_{tag}"] = report_timed(
            decode_case(B, M0, dh, bf16, seed=200 + i, heads=(H, Hk),
                        lens=[M0] * B),
            f"{arch} cross-attention decode over the memory (every "
            f"position valid)")
        out[f"self_decode_{tag}"] = report_timed(
            decode_case(B, S, dh, bf16, seed=205 + i, heads=(H, Hk),
                        lens=[S] * B),
            f"{arch} self-attention decode")
        check_merge(f"{arch} memory: B {B} S {M} ({M0} valid), {heads}",
                    B, M, LM_P, dh, bf16, seed=215 + i, lens=[M0] * B,
                    heads=(H, Hk))
        for key, Mall, plan in ((f"shard_{tag}", M, "prism"),
                                (f"vshard_{tag}", pad_len(M0, LM_P, 0),
                                 "voltage")):
            case = shard_case(B, Mall, LM_P, 1, dh, bf16, seed=210 + i,
                              lens=[M0] * B, heads=(H, Hk))
            errs = check_case(case, got=shard_partials(case))
            out[key] = t = dict(time_case(case),
                                max_abs_err=errs["max_abs_err"])
            bp = Mall // LM_P
            _print_shard(f"over {arch}'s memory block under {plan} (rank 1 "
                         f"of {LM_P}: B {B}, Mp {bp} of {Mall}, offset {bp}"
                         f", {M0 - bp} valid, bf16, {heads})", t, errs)
        case = shard_case(B, S, LM_P, 1, dh, bf16, seed=212 + i,
                          lens=[40] * B, heads=(H, Hk))
        errs = check_case(case, got=shard_partials(case))
        out[f"self_shard_{tag}"] = t = dict(time_case(case),
                                            max_abs_err=errs["max_abs_err"])
        _print_shard(f"over {arch}'s self-attention cache (rank 1 of {LM_P}:"
                     f" B {B}, Sp {S // LM_P} of {S}, offset {S // LM_P}, 16 "
                     f"valid, bf16, {heads})", t, errs)
        seg_rows = [(f"seg_{tag}", mem_seg_case(Mp, Hk * dh, M - M0,
                                                seed=220 + i),
                     f"{arch} memory block bf16 2 x [{B}, {Mp}, {Hk}·{dh}] "
                     f"L={LM_L}, last {M - M0} padding"),
                    (f"seg_self_{tag}",
                     seg_case(LM_B, np_, (Hk, dh), LM_L, bf16, seed=222 + i,
                              masked=False),
                     f"{arch} text partition bf16 2 x [{LM_B}, {np_}, "
                     f"{Hk}·{dh}] L={LM_L}")]
        if arch == WHISPER:
            seg_rows.append((
                "seg_enc_whisper",
                seg_case(LM_B, Mp, (Hk, dh), LM_L, bf16, seed=224,
                         masked=False),
                f"{arch} encoder block bf16 2 x [{LM_B}, {Mp}, {Hk}·{dh}] "
                f"L={LM_L}, unmasked"))
        for key, seg, label in seg_rows:
            err = check_seg_kv_steps(label, seg)
            out[key] = t = dict(time_seg(seg), max_abs_err=err)
            _print_seg(label, t)
        check_prism(f"{arch} cross, non-causal, {heads}, q [{B}, {np_}] "
                    f"over a memory block of {Mp} (part 0, all valid), "
                    f"means strided as gathered",
                    cross_prism_case(np_, arch, 0, seed=230 + i))
        prism_rows = [
            (f"prism_{tag}", cross_prism_case(np_, arch, 1, seed=235 + i),
             f"{arch} cross part 1 (masked, non-causal, Nq {np_} ≠ Nk "
             f"{Mp}: {M0 - Mp} of {Mp} keys valid, the last segment's mean "
             f"count {Mp // LM_L - (M - M0)})"),
            (f"prism_self_{tag}",
             prism_case(LM_B, np_, H, Hk, dh, LM_P, LM_L, bf16, seed=238 + i,
                        causal=True, part=1, masked=False, strided=True),
             f"{arch} decoder self-attention, causal, {heads}, q/K/V "
             f"[{LM_B}, {np_}], part 1, means strided as gathered")]
        if arch == WHISPER:
            prism_rows.append((
                "prism_enc_whisper",
                prism_case(LM_B, Mp, H, Hk, dh, LM_P, LM_L, bf16, seed=240,
                           causal=False, part=1, masked=False, strided=True),
                f"{arch} encoder, non-causal, unmasked, {heads}, q/K/V "
                f"[{LM_B}, {Mp}], part 1, means strided as gathered"))
        for key, pc, label in prism_rows:
            err = check_prism(label, pc)
            out[key] = t = dict(time_prism(pc), max_abs_err=err)
            _print_prism(label, t)
    return out


def _small_xattn(arch):
    """(reduced overrides, cfg, CPU params from seed 0 with the gates at
    XATTN_GATE, the memory input, forward tokens, prompt, decode tokens)
    of the small f32 ``arch`` (d 256, 8 heads of 64: 8 KV heads for
    whisper, 2 for the vision model)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    reduced = dict(dtype="float32", head_dim=64, n_heads=8, d_model=256,
                   n_kv_heads=8 if arch == WHISPER else 2)
    cfg = get_config(arch).reduced(**reduced)
    params = registry.init_params(cfg, seed=0, device="cpu")
    _open_gates(params)
    g = torch.Generator().manual_seed(0)
    extras = {_memory_name(cfg): torch.randn(SMALL_LM_B, SMALL_XATTN_M,
                                             cfg.d_model, generator=g)}
    return (reduced, cfg, params, extras,
            *(torch.randint(0, cfg.vocab_size, (SMALL_LM_B, n), generator=g)
              for n in (SMALL_LM_N, SMALL_LM_T0, SMALL_LM_STEPS)))


def _small_xattn_rank(rank, world, arch, device):
    """One rank of the small f32 ``arch`` on ``device``: ``voltage`` and
    ``prism`` forward logits, sharded decode steps over the memory's
    blocks, greedy tokens under both."""
    import torch
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.models import transformer as tfm
    _exact_fp32()
    reduced, cfg, params, extras, tokens, prompt, steps = _small_xattn(arch)
    plans = (ExecutionPlan.voltage(seq_shards=world),
             ExecutionPlan.prism(L=SMALL_LM_L, cr=1.0, seq_shards=world))
    session = InferenceSession(cfg, _on(params, device), device=device,
                               plans=list(plans))
    mem = _on(extras, device)
    out = {}
    with torch.inference_mode():
        for p in plans:
            out[f"fwd/{p.mode}"] = tfm.forward_lm(
                session.params, {"tokens": tokens.to(device), **mem}, cfg,
                p.to_exchange_config())[0].cpu()
    out["decode"] = _decode_steps(session.params, cfg,
                                  plans[0].to_exchange_config(), steps,
                                  device, extras=mem)
    for p in plans:
        out[f"gen/{p.mode}"] = session.generate(prompt, SMALL_LM_NEW, plan=p,
                                                batch_extras=mem).cpu()
    return {k: v.numpy() for k, v in out.items()}


def phase_small_xattn_reference() -> None:
    """The small f32 whisper and vision model (dh 64; a 13-token memory
    that pads to 16 under ``prism_sim`` and ``prism``; the vision gates at
    0.5) on the card against the same weights on the CPU.  In one
    process: ``local`` and ``prism_sim`` forward logits, 12 decode steps
    over the padded memory (self- and cross-attention through the
    flash-decode kernel) ≤ 1e-4, greedy tokens exact under both.  On 2
    ranks on the card against 2 ranks on the CPU: ``voltage`` and
    ``prism`` forward logits (the masked segment means and masked PRISM
    attention on the memory blocks), 12 sharded decode steps ≤ 1e-4,
    greedy tokens exact under both."""
    import numpy as np
    import torch
    from repro_torch.api import ExecutionPlan
    from repro_torch.api.generation import generate
    from repro_torch.models import transformer as tfm
    plans = {"local": ExecutionPlan.local(),
             "prism_sim": ExecutionPlan.prism_sim(L=SMALL_LM_L, cr=1.0)}
    for arch in XATTN_ARCHS:
        t0 = time.perf_counter()
        reduced, cfg, params, extras, tokens, prompt, steps = \
            _small_xattn(arch)
        side = {}
        for dev in ("cpu", "cuda"):
            p, mem = _on(params, dev), _on(extras, dev)
            r = side[dev] = {}
            for key, plan in plans.items():
                xcfg = plan.to_exchange_config()
                with torch.inference_mode():
                    r[f"fwd/{key}"] = tfm.forward_lm(
                        p, {"tokens": tokens.to(dev), **mem}, cfg,
                        xcfg)[0].cpu()
                r[f"gen/{key}"] = generate(p, prompt.to(dev), SMALL_LM_NEW,
                                           cfg, xcfg,
                                           batch_extras=mem).cpu()
            r["decode"] = _decode_steps(
                p, cfg, plans["prism_sim"].to_exchange_config(), steps, dev,
                extras=mem)
        cpu, gpu = side["cpu"], side["cuda"]
        worst = {k: (gpu[k] - cpu[k]).abs().max().item()
                 for k in ("fwd/local", "fwd/prism_sim", "decode")}
        for key, err in worst.items():
            if not err <= 1e-4:
                raise AssertionError(f"small f32 {arch} {key}: card vs CPU "
                                     f"differ by {err:.3e} > 1e-4")
        for key in ("gen/local", "gen/prism_sim"):
            if not torch.equal(gpu[key], cpu[key]):
                raise AssertionError(f"small f32 {arch} {key}: card tokens "
                                     f"differ from the CPU's")
        ranks = _both_devices(_small_xattn_rank, LM_P, arch)
        want = ranks["cpu"][0]
        seq = {}
        for key in ("fwd/voltage", "fwd/prism", "decode"):
            seq[key] = max(float(np.abs(r[key] - want[key]).max())
                           for r in ranks["cuda"])
            if not seq[key] <= 1e-4:
                raise AssertionError(f"small f32 {arch} {key}: {LM_P} ranks "
                                     f"on the card vs {LM_P} on the CPU "
                                     f"differ by {seq[key]:.3e} > 1e-4")
        for key in ("gen/voltage", "gen/prism"):
            for r in ranks["cuda"] + ranks["cpu"]:
                if not np.array_equal(r[key], want[key]):
                    raise AssertionError(f"small f32 {arch} {key}: greedy "
                                         f"tokens differ across ranks/devices")
        n_self, n_mem = _memory_layers(cfg)
        print(f"[reference] reduced f32 {arch} ({n_self} self-attention and "
              f"{n_mem} cross-attention decoder layers"
              + (f", {cfg.encoder_layers} encoder layers"
                 if cfg.family == "audio" else "")
              + f", d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads dh "
              f"{cfg.hd}, a {SMALL_XATTN_M}-token memory): on the card vs "
              f"the CPU, max |logit diff| local {worst['fwd/local']:.2e}, "
              f"prism_sim {worst['fwd/prism_sim']:.2e}, {SMALL_LM_STEPS} "
              f"decode steps over the padded memory {worst['decode']:.2e} "
              f"(tol 1e-4), greedy tokens exact under both; {LM_P} ranks on "
              f"the card vs {LM_P} on the CPU: voltage "
              f"{seq['fwd/voltage']:.2e}, prism(L={SMALL_LM_L}) "
              f"{seq['fwd/prism']:.2e}, {SMALL_LM_STEPS} sharded decode "
              f"steps {seq['decode']:.2e}, greedy tokens exact under both; "
              f"{time.perf_counter() - t0:.1f} s with rank start-up",
              flush=True)


def phase_xattn_arch(card: str, arch: str) -> dict:
    """``arch`` at full width and depth, bf16, random weights from seed 0
    (the vision gates at 0.5): ``prefill_memory``'s time (whisper: its
    32-layer encoder over 1500 frames), the measured profile at B 1 and 4
    and one ``dispatch`` with the memory input, then greedy ``generate``
    of [4, 32] + 16 with the memory (``local``; whisper also
    ``prism_sim``), flash-decode launches counted for the self- and the
    cross-attention apart and asserted, the prefill (the memory and the
    prompt) and the decode steps timed apart, the device's idle share
    (``local``) and the peak memory → launches."""
    import dataclasses
    import gc
    import torch
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.api import generation as gen_api
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models import registry
    from repro_torch.models import transformer as tfm
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch),
                              **XATTN_ARCH_CUT.get(arch, {}))
    params = registry.init_params(cfg, seed=0, device="cuda")
    _open_gates(params)
    plans = [ExecutionPlan.local()] + (
        [ExecutionPlan.prism_sim(L=4, cr=9.9)] if cfg.family == "audio"
        else [])
    session = InferenceSession(cfg, params, device="cuda", plans=plans)
    n_params = sum(t.numel() for t in _leaves(params))
    del params
    n_self, n_mem = _memory_layers(cfg)
    M0, name = _memory_len(cfg), _memory_name(cfg)
    g = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (PROMPT_B, PROMPT_T),
                           generator=g, device="cuda")
    extras = {name: torch.randn(PROMPT_B, M0, cfg.d_model, generator=g,
                                device="cuda").to(cfg.torch_dtype)}
    torch.cuda.synchronize()
    enc = (f"{cfg.encoder_layers} encoder layers, " if cfg.family == "audio"
           else "")
    depth = "cut" if arch in XATTN_ARCH_CUT else "and depth"
    print(f"[session] {arch} full width {depth} ({enc}{n_self} "
          f"self-attention and {n_mem} cross-attention decoder layers, d "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, dh "
          f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}; {n_params / 1e9:.2f} B parameters, "
          f"{registry.weight_bytes(cfg) / 1e9:.2f} GB, drawn on the card "
          f"from seed 0; memory {M0} {name}) built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    local = plans[0].to_exchange_config()

    def memory():
        cache = tfm.init_decode_cache(cfg, PROMPT_B, PROMPT_T + N_NEW,
                                      device="cuda")
        with torch.inference_mode():
            return tfm.prefill_memory(session.params, extras, cfg, local,
                                      cache)
    memory()
    mem_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        memory()
        torch.cuda.synchronize()
        mem_ms.append((time.perf_counter() - t1) * 1e3)
    pm, scale, raw = measured_profile(
        session, dict(batches=(1, 4), crs=(9.9,), bandwidths_mbps=(400.0,)),
        iters=2)
    print_measured(arch, pm, scale, raw, card)
    one = {"tokens": prompt[:1], name: extras[name][:1]}
    logits = session.dispatch(one)
    rec = session.history[-1]
    if logits.shape != (1, PROMPT_T, cfg.vocab_size) or not torch.isfinite(
            logits).all():
        raise AssertionError(f"{arch}: dispatch logits "
                             f"{tuple(logits.shape)} not finite / wrong")
    print(f"[memory-model] {arch}: prefill_memory of B {PROMPT_B} "
          + (f"(the encoder over {M0} frames and {n_mem} layers' K/V)"
             if cfg.family == "audio" else f"({n_mem} layers' K/V of {M0} "
                                           f"image tokens)")
          + f" {statistics.median(mem_ms):.2f} ms (median of 3); dispatch of"
          f" [1, {PROMPT_T}] with its memory ran {rec.exec_key!r} in "
          f"{rec.wall_ms:.1f} ms [{card}]", flush=True)
    del logits

    def timed(fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.inference_mode():
            out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t1) * 1e3
    launches = {"self": 0, "cross": 0}
    for plan in plans:
        xcfg = plan.to_exchange_config()
        mode = gen_api.resolve_prefill_mode(cfg, xcfg)
        session.generate(prompt, 2, plan=plan, batch_extras=extras)  # warm-up
        flash_decode.launches = 0                            # the main path
        with Inside(tfm, "decode_attention_sharded",
                    {"flash_decode": flash_decode}) as cross:
            out, w = timed(lambda: session.generate(
                prompt, N_NEW, plan=plan, batch_extras=extras))
        total, n_cross = flash_decode.launches, cross.counts["flash_decode"]
        steps = N_NEW - 1 + (PROMPT_T if mode == "scan" else 0)

        # generate's parts timed apart: the memory and the prompt's
        # prefill, then the decode steps
        def prefill():
            cache = tfm.init_decode_cache(cfg, PROMPT_B, PROMPT_T + N_NEW,
                                          device="cuda")
            return gen_api.prefill_prompt(session.params, prompt, extras,
                                          cache, cfg, xcfg, mode)
        (logits, cache), w_pre = timed(prefill)
        tok = gen_api.sample_token(logits, None)[:, 0:1]
        rest, w_dec = timed(lambda: gen_api.decode_scan(
            session.params, cache, tok, PROMPT_T, None, cfg, xcfg, 0.0,
            N_NEW - 1)[0])
        if not torch.equal(torch.cat([tok, rest], dim=1), out):
            raise AssertionError(f"{arch} {plan.key}: prefill and decode "
                                 f"timed apart drew other tokens than "
                                 f"generate")
        del cache
        if (total - n_cross, n_cross) != (steps * n_self, steps * n_mem):
            raise AssertionError(
                f"{arch} {plan.key}: flash_decode launched {total - n_cross}"
                f" (self) + {n_cross} (cross) times, want {steps} steps x "
                f"({n_self} + {n_mem}) layers")
        launches["self"] += total - n_cross
        launches["cross"] += n_cross
        if out.shape != (PROMPT_B, N_NEW) or not (
                (out >= 0) & (out < cfg.vocab_size)).all():
            raise AssertionError(f"{arch} {plan.key}: bad tokens")
        with torch.inference_mode():
            lg = tfm.forward_lm(session.params,
                                {"tokens": torch.cat([prompt, out], dim=1),
                                 **extras}, cfg, xcfg, last_only=True)[0]
        if not torch.isfinite(lg).all():
            raise AssertionError(f"{arch} {plan.key}: non-finite logits over"
                                 f" the generated sequence")
        decode_ms = w_dec / (N_NEW - 1)
        print(f"[generate] {arch} {plan.key}: [{PROMPT_B}, {PROMPT_T}] "
              f"prompt + {N_NEW} greedy tokens with the {M0}-token memory in "
              f"{w:.1f} ms; flash_decode launches {total} = {steps} steps x "
              f"({n_self} self-attention + {n_mem} cross-attention layers), "
              f"{n_cross} of them over the memory; timed apart: prefill "
              f"({mode}, the memory included) {w_pre:.1f} ms, decode "
              f"{decode_ms:.2f} ms/token step, "
              f"{PROMPT_B / decode_ms * 1e3:.1f} tokens/s at B={PROMPT_B} "
              f"[{card}]", flush=True)
        if plan.mode == "local":
            print_breakdown(f"{arch} {plan.key}", lambda: session.generate(
                prompt, N_NEW, plan=plan, batch_extras=extras), w)
    peak = torch.cuda.max_memory_allocated()
    print(f"[memory] {arch}: peak allocated {peak / 1e9:.2f} GB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB "
          f"[{card}]", flush=True)
    del session
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def xattn_seq_bytes(cfg, plan: str, P: int) -> dict:
    """What each rank's staged calls receive in one ``forward_lm`` of
    [LM_B, LM_N] with the memory under ``plan``, from shapes: every
    exchange's K and V (whisper's encoder over the frames, unmasked; the
    decoder's self-attention over the text; each cross layer over the
    memory), in full under ``voltage``, L means a partition under
    ``prism``; a cross layer's mask (``voltage``) or its means' counts
    (``prism``) as meta; one call each, a cross layer two, and the last
    logits' broadcast."""
    from repro_torch.models.transformer import pad_len
    if plan == "local":
        return dict(payload=0, meta=0, calls=0)
    prism = plan == "prism"
    Mp = pad_len(_memory_len(cfg), P, LM_L if prism else 0) // P
    kv = LM_B * cfg.n_kv_heads * cfg.hd * 2 * cfg.torch_dtype.itemsize
    n_self, n_mem = _memory_layers(cfg)
    n_enc = cfg.encoder_layers if cfg.family == "audio" else 0

    def per(n):
        return (P - 1) * (LM_L if prism else n) * kv
    return dict(payload=n_enc * per(Mp) + n_self * per(LM_N // P)
            + n_mem * per(Mp),
            meta=n_mem * (P - 1) * LM_B * (LM_L * 4 if prism else Mp),
            calls=n_enc + n_self + 2 * n_mem + 1)


def _xattn_seq_rank(rank, world):
    """One rank of whisper-large-v3 and then llama-3.2-vision-11b at full
    width, cut to XATTN_SEQ's layers, on the shared card: the
    ``last_only`` forward of [LM_B, LM_N] with the memory under each plan
    (launches, whisper's encoder's, the decoder's self-attention's and
    the cross layers' apart, payload and meta bytes and calls asserted),
    then greedy ``generate`` of [PROMPT_B, PROMPT_T] + N_NEW under
    ``voltage`` and under ``prism`` (flash-decode launches, the memory's
    shard partials apart, asserted; tokens equal on both ranks; the
    ``voltage`` tokens' agreement with this rank's ``local`` counted), and
    the same weights in f32 under ``voltage`` token-exact against
    ``local``."""
    import dataclasses
    import gc
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
    kernels = {"segment_means": segment_means,
               "prism_attention": prism_attention}
    res = {}
    for arch, cut in XATTN_SEQ:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), **cut)
        params = registry.init_params(cfg, seed=0, device="cuda")
        _open_gates(params)
        sums = torch.stack([leaf.double().sum() for leaf in
                            _leaves(params)]).cpu().numpy().tobytes()
        if group.broadcast_object(sums) != sums:
            raise AssertionError(f"rank {rank}: {arch} weights differ from "
                                 f"rank 0's")
        plans = {"local": ExecutionPlan.local(),
                 "voltage": ExecutionPlan.voltage(seq_shards=world),
                 "prism": ExecutionPlan.prism(
                     L=LM_L, cr=LM_N / (LM_L * world), seq_shards=world)}
        session = InferenceSession(cfg, params, device="cuda",
                                   plans=list(plans.values()))
        del params
        build_s = time.perf_counter() - t0
        n_self, n_mem = _memory_layers(cfg)
        name, M0 = _memory_name(cfg), _memory_len(cfg)
        g = torch.Generator(device="cuda").manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (LM_B, LM_N), generator=g,
                               device="cuda")
        mem = torch.randn(LM_B, M0, cfg.d_model, generator=g,
                          device="cuda").to(cfg.torch_dtype)
        prompt = torch.randint(0, cfg.vocab_size, (PROMPT_B, PROMPT_T),
                               generator=g, device="cuda")
        extras = {name: mem[:PROMPT_B]}

        def forward(key):
            with torch.inference_mode():
                return tfm.forward_lm(session.params,
                                      {"tokens": tokens, name: mem}, cfg,
                                      plans[key].to_exchange_config(),
                                      last_only=True)[0]
        for key in plans:                               # warm-up
            forward(key)
        fwd = {}
        for key in plans:                               # the main path
            segment_means.launches = prism_attention.launches = 0
            with Inside(tfm, "exchange_cross_attention", kernels) as cross, \
                    Inside(tfm, "_encode_audio", kernels) as enc:
                last, *_ = _timed(lambda: forward(key), group)
            counts = (segment_means.launches, prism_attention.launches)
            st = group.stats
            got = dict(payload=st.payload_bytes, meta=st.meta_bytes,
                       calls=st.calls)
            want = xattn_seq_bytes(cfg, key, world)
            if got != want:
                raise AssertionError(f"rank {rank} {arch} {key}: staged "
                                     f"{got}, the shapes give {want}")
            n_enc = cfg.encoder_layers if cfg.family == "audio" else 0
            on = key == "prism"
            kinds = {"enc": enc, "cross": cross}
            apart = {kind: tuple(c.counts[k] for k in kernels)
                     for kind, c in kinds.items()}
            apart["self"] = tuple(counts[j] - apart["enc"][j]
                                  - apart["cross"][j] for j in range(2))
            want = {kind: (n * on,) * 2 for kind, n in (
                ("enc", n_enc), ("cross", n_mem), ("self", n_self))}
            if apart != want:
                raise AssertionError(f"rank {rank} {arch} {key}: "
                                     f"(segment_means, prism_attention) "
                                     f"launches {apart} by layer kind; want "
                                     f"{want}")
            if not torch.isfinite(last).all():
                raise AssertionError(f"rank {rank} {arch} {key}: last "
                                     f"logits not finite")
            both = group.all_gather(last, kind="meta")
            if not torch.equal(both[0], both[1]):
                raise AssertionError(f"{arch} {key}: last logits differ "
                                     f"between ranks")
            runs = [_timed(lambda: forward(key), group) for _ in range(3)]
            fwd[key] = dict(got, counts=counts, kinds=apart,
                            ms=statistics.median(r[1] for r in runs),
                            staged_ms=statistics.median(r[2] for r in runs))
        want = session.generate(prompt, N_NEW, plan=plans["local"],
                                batch_extras=extras)
        session.generate(prompt, 2, plan=plans["voltage"],
                         batch_extras=extras)                # warm-up
        flash_decode.launches = 0                            # the main path
        with Inside(tfm, "decode_attention_sharded",
                    {"flash_decode": flash_decode}) as cross:
            out, w, sd, cd, md = _timed(
                lambda: session.generate(prompt, N_NEW, plan=plans["voltage"],
                                         batch_extras=extras), group)
        launches, n_cross = flash_decode.launches, \
            cross.counts["flash_decode"]
        steps = N_NEW - 1                            # single-pass prefill
        if (launches - n_cross, n_cross) != (steps * n_self,
                                             steps * n_mem):
            raise AssertionError(f"rank {rank} {arch} voltage generate: "
                                 f"flash_decode launched "
                                 f"{launches - n_cross} + {n_cross} times, "
                                 f"want {steps} x ({n_self} + {n_mem})")
        both = group.all_gather(out, kind="meta")
        if not torch.equal(both[0], both[1]):
            raise AssertionError(f"{arch} voltage: the ranks drew different "
                                 f"tokens")
        agree = (out == want).float().mean().item()
        flash_decode.launches = 0                            # the main path
        t1 = time.perf_counter()
        with Inside(tfm, "decode_attention_sharded",
                    {"flash_decode": flash_decode}) as pcross:
            pout = session.generate(prompt, N_NEW, plan=plans["prism"],
                                    batch_extras=extras)
        prism_s = time.perf_counter() - t1
        p_launches, p_cross = flash_decode.launches, \
            pcross.counts["flash_decode"]
        p_steps = PROMPT_T + N_NEW - 1               # decode-loop prefill
        if (p_launches - p_cross, p_cross) != (p_steps * n_self,
                                               p_steps * n_mem):
            raise AssertionError(f"rank {rank} {arch} prism generate: "
                                 f"flash_decode launched "
                                 f"{p_launches - p_cross} + {p_cross} "
                                 f"times, want {p_steps} x ({n_self} + "
                                 f"{n_mem})")
        both = group.all_gather(pout, kind="meta")
        if not torch.equal(both[0], both[1]):
            raise AssertionError(f"{arch} prism: the ranks drew different "
                                 f"tokens")
        peak = torch.cuda.max_memory_allocated()
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params32 = _cast(session.params, torch.float32)
        del session
        gc.collect()
        torch.cuda.empty_cache()
        s32 = InferenceSession(cfg32, params32, device="cuda",
                               plans=[plans["local"], plans["voltage"]])
        del params32
        ext32 = {name: extras[name].float()}
        want32 = s32.generate(prompt, N_NEW, plan=plans["local"],
                              batch_extras=ext32)
        got32 = s32.generate(prompt, N_NEW, plan=plans["voltage"],
                             batch_extras=ext32)
        if not torch.equal(got32, want32):
            raise AssertionError(f"rank {rank} {arch} f32: voltage tokens "
                                 f"{got32.tolist()} differ from local's "
                                 f"{want32.tolist()}")
        res[arch] = dict(fwd=fwd, build_s=build_s, gen_s=w / 1e3,
                         gen_staged_s=sd / 1e3, gen_calls=cd, gen_merge=md,
                         launches=launches, cross=n_cross, agree=agree,
                         prism_s=prism_s, prism_launches=p_launches,
                         prism_cross=p_cross, peak=peak)
        del s32
        gc.collect()
        torch.cuda.empty_cache()
    return res


def phase_xattn_seq(card: str) -> dict:
    """whisper-large-v3 and llama-3.2-vision-11b at full width, cut to
    XATTN_SEQ's layers, on 2 ranks sharing the card → launch totals over
    the ranks: segment means and PRISM attention of the ``prism`` forwards
    by layer kind (whisper's encoder, the decoder's self-attention, the
    cross layers), flash-decode's shard partials over the memory in the
    ``voltage`` and the ``prism`` generates, and over the self-attention
    cache in both."""
    from repro_torch.configs import get_config
    from repro_torch.core.seq_group import spawn
    from repro_torch.models.transformer import pad_len
    t0 = time.perf_counter()
    ranks = spawn(_xattn_seq_rank, LM_P, timeout=RANK_TIMEOUT_S)
    out = {}
    for i, (arch, cut) in enumerate(XATTN_SEQ):
        tag = ("whisper", "vision")[i]
        full = get_config(arch)
        r0, r1 = ranks[0][arch], ranks[1][arch]
        print(f"[xattn-seq] {arch} full width cut to {cut}, "
              f"{full.n_heads}/{full.n_kv_heads} heads dh {full.hd}, "
              f"{_memory_len(full)} {_memory_name(full)}, bf16, random "
              f"weights from seed 0, equal on both ranks; {LM_P} ranks "
              f"sharing the card, gloo staged through host memory; built in "
              f"{r0['build_s']:.1f} s, peak {r0['peak'] / 1e9:.2f} GB a rank",
              flush=True)
        for key, f in r0["fwd"].items():
            share = f["staged_ms"] / f["ms"] if f["ms"] else 0.0
            sm, pa = f["counts"]
            kinds = ", ".join(f"{kind} {n[0]}" for kind, n in
                              f["kinds"].items() if n[0])
            print(f"[xattn-seq] {arch} forward_lm(last_only) {key}: B={LM_B}"
                  f" N={LM_N}, per rank {f['ms']:.2f} ms (rank 1: "
                  f"{r1['fwd'][key]['ms']:.2f} ms), staged "
                  f"{f['staged_ms']:.2f} ms ({share:.1%}) in {f['calls']} "
                  f"calls; received {f['payload'] / 1e6:.4f} MB payload + "
                  f"{f['meta'] / 1e3:.2f} kB meta (masks or counts), = the "
                  f"shapes' count; segment_means {sm}, prism_attention {pa} "
                  f"launches each{' (' + kinds + ')' if kinds else ''} "
                  f"(median of 3) [{card}]", flush=True)
        print(f"[xattn-seq] {arch} generate voltage [{PROMPT_B}, {PROMPT_T}]"
              f" + {N_NEW} with the memory: {r0['gen_s']:.3f} s "
              f"({r0['gen_staged_s']:.3f} s staged in {r0['gen_calls']} "
              f"calls, {r0['gen_merge'] / 1e3:.1f} kB of merge partials), "
              f"the same tokens on both ranks, {r0['agree']:.0%} of them "
              f"local's in bf16 (rank 1: {r1['agree']:.0%}); the same "
              f"weights in f32 token-exact against local on both ranks; "
              f"flash_decode launches {r0['launches']} a rank, "
              f"{r0['cross']} of them shard partials over the memory "
              f"[{card}]", flush=True)
        print(f"[xattn-seq] {arch} generate prism(L={LM_L}) [{PROMPT_B}, "
              f"{PROMPT_T}] + {N_NEW} with the memory (decode-loop prefill):"
              f" {r0['prism_s']:.3f} s, the same tokens on both ranks; "
              f"flash_decode launches {r0['prism_launches']} a rank, "
              f"{r0['prism_cross']} of them shard partials over the memory "
              f"[{card}]", flush=True)
        for kind in ("enc", "self", "cross"):
            for j, kname in enumerate(("segment_means", "prism_attention")):
                out[f"{kname}_{kind}_{tag}"] = sum(
                    r[arch]["fwd"]["prism"]["kinds"][kind][j] for r in ranks)
        out[f"flash_decode_voltage_{tag}"] = sum(r[arch]["cross"]
                                                 for r in ranks)
        out[f"flash_decode_prism_{tag}"] = sum(r[arch]["prism_cross"]
                                               for r in ranks)
        out[f"flash_decode_self_{tag}"] = sum(
            r[arch]["launches"] - r[arch]["cross"] + r[arch]["prism_launches"]
            - r[arch]["prism_cross"] for r in ranks)
        kv = LM_B * full.n_kv_heads * full.hd * 2 * 2
        Mv = pad_len(_memory_len(full), LM_P, 0) // LM_P
        print(f"[xattn-seq] {arch} bytes a cross layer a rank, from shapes: "
              f"voltage K+V {LM_B} x {Mv} x {full.n_kv_heads} x {full.hd} x "
              f"2 x 2 B = {Mv * kv / 1e6:.2f} MB (+ the mask, {LM_B * Mv} "
              f"B); prism(L={LM_L}) {LM_B} x {LM_L} means = "
              f"{LM_L * kv / 1e6:.3f} MB (+ counts, {LM_B * LM_L * 4} B)",
              flush=True)
    print(f"[xattn-seq] {time.perf_counter() - t0:.1f} s with rank start-up",
          flush=True)
    return out


def xattn_kernel_rows(xa: dict, xk: dict, xs: dict, replaces: dict,
                      keys: tuple) -> list:
    """The kernels line's rows of the memory models: one a shape their
    main paths launch a kernel at, its numbers from ``phase_xattn_kernels``
    (``xk``) and its launches from ``[arch]`` (``xa``) or ``[xattn-seq]``
    (``xs``)."""
    from repro_torch.models.transformer import pad_len
    S, out = PROMPT_T + N_NEW, []
    for i, arch in enumerate(XATTN_ARCHS):
        tag = ("whisper", "vision")[i]
        H, Hk, dh, M0, M = _memory_shape(arch)
        Mp, Mv = M // LM_P, pad_len(M0, LM_P, 0) // LM_P
        heads = f"{H}/{Hk} heads dh={dh}"
        rows_x = [
            ("flash_decode", xa[arch]["cross"], xk[f"decode_{tag}"],
             f"{arch} cross-attention decode over the memory: bf16 "
             f"B={PROMPT_B} S={M0} (every position valid) {heads}; "
             f"launches: the memory's, in `[arch]`"),
            ("flash_decode", xa[arch]["self"], xk[f"self_decode_{tag}"],
             f"{arch} self-attention decode: bf16 B={PROMPT_B} S={S} "
             f"{heads}; launches: the self-attention's, in `[arch]`"),
            ("flash_decode", xs[f"flash_decode_voltage_{tag}"],
             xk[f"vshard_{tag}"],
             f"{arch} shard partial over the memory ({LM_P} ranks, the "
             f"blocks padded for P): bf16 B={PROMPT_B} Mp={Mv} of "
             f"{Mv * LM_P}, offset {Mv}, {M0 - Mv} valid, {heads}; "
             f"launches: the memory's, in `[xattn-seq]`'s voltage generate"),
            ("flash_decode", xs[f"flash_decode_prism_{tag}"],
             xk[f"shard_{tag}"],
             f"{arch} shard partial over the memory ({LM_P} ranks, the "
             f"blocks padded for P and L={LM_L}): bf16 B={PROMPT_B} "
             f"Mp={Mp} of {M}, offset {Mp}, {M0 - Mp} valid, {heads}; "
             f"launches: the memory's, in `[xattn-seq]`'s prism generate"),
            ("flash_decode", xs[f"flash_decode_self_{tag}"],
             xk[f"self_shard_{tag}"],
             f"{arch} shard partial over the self-attention cache ({LM_P} "
             f"ranks): bf16 B={PROMPT_B} Sp={S // LM_P} of S={S}, offset "
             f"{S // LM_P}, {heads}; launches: the self-attention's, in "
             f"`[xattn-seq]`'s voltage and prism generates"),
            ("segment_means", xs[f"segment_means_cross_{tag}"],
             xk[f"seg_{tag}"],
             f"{arch} cross prism per rank: the memory block's K and V "
             f"bf16 [{PROMPT_B}, {Mp}, {Hk}·{dh}] L={LM_L}, masked "
             f"(last {M - M0} padding)"),
            ("segment_means", xs[f"segment_means_self_{tag}"],
             xk[f"seg_self_{tag}"],
             f"{arch} decoder self-attention prism per rank: K and V bf16 "
             f"[{LM_B}, {LM_N // LM_P}, {Hk}·{dh}] L={LM_L}"),
            ("prism_attention", xs[f"prism_attention_cross_{tag}"],
             xk[f"prism_{tag}"],
             f"{arch} cross prism per rank: bf16 q [{PROMPT_B}, "
             f"{LM_N // LM_P}] over {Mp} keys, {heads}, masked, "
             f"non-causal, L={LM_L} part 1"),
            ("prism_attention", xs[f"prism_attention_self_{tag}"],
             xk[f"prism_self_{tag}"],
             f"{arch} decoder self-attention prism per rank: bf16 q/K/V "
             f"[{LM_B}, {LM_N // LM_P}] {heads}, causal, L={LM_L} part 1")]
        if arch == WHISPER:
            rows_x += [
                ("segment_means", xs["segment_means_enc_whisper"],
                 xk["seg_enc_whisper"],
                 f"{arch} encoder prism per rank: the frame block's K and V "
                 f"bf16 [{LM_B}, {Mp}, {Hk}·{dh}] L={LM_L}, unmasked"),
                ("prism_attention", xs["prism_attention_enc_whisper"],
                 xk["prism_enc_whisper"],
                 f"{arch} encoder prism per rank: bf16 q/K/V [{LM_B}, {Mp}] "
                 f"{heads}, non-causal, unmasked (the padded frames "
                 f"attended), L={LM_L} part 1")]
        out += [{"name": kname, "route": "cuda",
                 "source": f"src/repro_torch/kernels/{kname}/csrc/{kname}.cu",
                 "replaces": replaces[kname], "launches": n, "shape": shape,
                 **{k: t[k] for k in keys}} for kname, n, t, shape in rows_x]
    return out


# ---------------------------------------------------------------------------
# the recurrent families: hymba-1.5b (hybrid) and xlstm-350m (ssm)
# ---------------------------------------------------------------------------

HYMBA, XLSTM = "hymba-1.5b", "xlstm-350m"
# [arch]'s depth cuts (PERF.md §4), each a host-bound loop over layers that
# kept the script near its time limit: the moe family's dense first layer
# and one of experts; 8 of qwen1.5-32b's 64, 3 of gemma2's 23
# local/global pairs, 4 of hymba's 32, half of internlm2-1.8b's 24, one of
# xlstm-350m's 3 groups (for the time of [examples] and the recompute;
# before them: 4, 4, 32, 24, 16, whole, whole)
ARCH_LAYERS = {MOE: 2, MLA_ARCH: 2, "qwen1.5-32b": 8, GEMMA: 6, HYMBA: 4,
               "internlm2-1.8b": 12, XLSTM: 8}
SSM_ARCHS = (HYMBA, XLSTM)
# [arch]'s slot pool: more requests than slots, so a slot is re-admitted
SSM_SERVE_REQUESTS, SSM_SERVE_SLOTS, SSM_SERVE_CHUNK = 3, 2, 8
# [arch]'s kernel time: torch.profiler over this many decode steps from a
# primed cache (over a whole generate, 47 steps of ~2000 launches, the
# profiler alone took most of a minute)
SSM_PROFILE_STEPS = 4
# [ssm-seq]: full width; hymba cut to 4 of its 32 layers, xLSTM to one of
# its 3 groups (8 layers and whole before, for time: its 21 mLSTM states
# handed on 352 MB a hop at B 4)
SSM_SEQ = ((HYMBA, dict(n_layers=4)), (XLSTM, dict(n_layers=8)))
# the small f32 models: hymba at G 5 (10/2 heads of 64) with n_heads·hd = d
# (hymba runs only there, in both packages), and a two-group xLSTM
SMALL_SSM = {
    "hymba": (HYMBA, dict(dtype="float32", head_dim=64, n_heads=10,
                          n_kv_heads=2, d_model=640)),
    "xlstm": (XLSTM, dict(dtype="float32", d_model=256, n_layers=4))}


def _print_decode(label: str, t: dict, errs: dict, tol: float) -> None:
    print(f"[kernel] flash_decode {label}: err {err_text(errs)} (tol "
          f"{tol:g}) | kernel {t['ms']*1e3:.2f} us, bound "
          f"{t['bound_ms']*1e3:.2f} us ({t['bound_by']}), plain "
          f"{t['plain_ms']*1e3:.2f} us, sdpa yardstick "
          f"{t['library_ms']*1e3:.2f} us", flush=True)


def phase_ssm_kernels() -> dict:
    """The kernels at every shape hymba-1.5b's main paths give them (25/5
    heads, dh 64: a group of G = 5 query heads a KV head, the first that
    is neither a power of two nor a divisor of a warp, so the kernels'
    row tiles run part full), each held against its plain version over
    every head and timed beside its bound and the library yardstick.
    Flash-decode at B 4, S 48 in bf16 and f32 (every position valid),
    and at random lengths with a fully masked row (checked); at the slot
    pool's shapes: its step at B SSM_SERVE_SLOTS, S 48 with each slot's
    own length (a ``[B]`` cache index), and its admissions' B 1
    decode-loop prefill over S 48 (32 valid); the shard
    partial of rank 1 of 2 (Sp 24 of 48, 16 valid) in both types, every
    block merged against the dense kernel with a block holding no valid
    position; the segment means of K and V [4, 256, 5·64] at L 16 in one
    launch; causal PRISM attention of q [4, 256, 25, 64] over 5 KV heads,
    both partitions' means as gathered, parts 0 and 1."""
    import torch
    from repro_torch.configs import get_config
    bf16, f32 = torch.bfloat16, torch.float32
    c = get_config(HYMBA)
    H, Hk, dh = c.n_heads, c.n_kv_heads, c.hd
    B, S, np_ = PROMPT_B, PROMPT_T + N_NEW, LM_N // LM_P
    heads = f"{H}/{Hk} heads dh {dh}, G {H // Hk}"
    out = {"decode": report_timed(
        decode_case(B, S, dh, bf16, seed=300, heads=(H, Hk), lens=[S] * B),
        f"{HYMBA} decode (G {H // Hk})")}
    case = decode_case(B, S, dh, f32, seed=301, heads=(H, Hk), lens=[S] * B)
    errs = check_case(case)
    out["decode_f32"] = t = dict(time_case(case),
                                 max_abs_err=errs["max_abs_err"])
    _print_decode(f"{HYMBA} decode f32 B={B} S={S} {heads}", t, errs, 1e-5)
    out["pool"] = report_timed(
        decode_case(SSM_SERVE_SLOTS, S, dh, bf16, seed=303, heads=(H, Hk),
                    lens=[40, 17][:SSM_SERVE_SLOTS]),
        f"{HYMBA} slot pool step, per-slot lengths 40/17 (G {H // Hk})")
    out["prefill"] = report_timed(
        decode_case(1, S, dh, bf16, seed=304, heads=(H, Hk), lens=[PROMPT_T]),
        f"{HYMBA} slot pool admission, B 1 prefill step, {PROMPT_T} valid "
        f"(G {H // Hk})")
    for dtype in (bf16, f32):
        errs = check_case(decode_case(B, S, dh, dtype, seed=302,
                                      heads=(H, Hk), masked_row=True))
        print(f"[kernel] flash_decode {HYMBA} {str(dtype).split('.')[1]} "
              f"B={B} S={S} {heads}, random lengths, row 0 fully masked: "
              f"err {err_text(errs)} (tol {_tol(dtype):g}), every head",
              flush=True)
    for dtype, key in ((bf16, "shard"), (f32, "shard_f32")):
        name = str(dtype).split(".")[1]
        check_merge(f"{HYMBA} {name}: B {B} S {S}, lengths 40/17/24/48 (a "
                    f"block with no valid position), {heads}", B, S, LM_P,
                    dh, dtype, seed=305, lens=[40, 17, 24, 48], heads=(H, Hk))
        case = shard_case(B, S, LM_P, 1, dh, dtype, seed=306, lens=[40] * B,
                          heads=(H, Hk))
        errs = check_case(case, got=shard_partials(case))
        out[key] = t = dict(time_case(case), max_abs_err=errs["max_abs_err"])
        _print_decode(f"shard partial {HYMBA} {name} (rank 1 of {LM_P}: B "
                      f"{B}, Sp {S // LM_P} of {S}, offset {S // LM_P}, 16 "
                      f"valid, {heads})", t, errs, _tol(dtype))
    label = (f"{HYMBA} prism per rank bf16 2 x [{LM_B}, {np_}, {Hk}·{dh}] "
             f"L={LM_L}")
    seg = seg_case(LM_B, np_, (Hk, dh), LM_L, bf16, seed=310, masked=False)
    err = check_seg_kv_steps(label, seg)
    out["seg"] = t = dict(time_seg(seg), max_abs_err=err)
    _print_seg(label, t)
    for part in range(LM_P):
        label = (f"{HYMBA} causal, {heads}, q/K/V [{LM_B}, {np_}], part "
                 f"{part}, means strided as gathered")
        pc = prism_case(LM_B, np_, H, Hk, dh, LM_P, LM_L, bf16,
                        seed=315 + part, causal=True, part=part,
                        masked=False, strided=True)
        err = check_prism(label, pc)
        out[f"prism_{part}"] = t = dict(time_prism(pc), max_abs_err=err)
        _print_prism(label, t)
    return out


def _small_ssm(label):
    """(arch, reduced overrides, cfg, CPU params from seed 0, forward
    tokens, prompt, decode tokens) of the small f32 model ``label``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    arch, reduced = SMALL_SSM[label]
    cfg = get_config(arch).reduced(**reduced)
    params = registry.init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(0)
    return (arch, reduced, cfg, params,
            *(torch.randint(0, cfg.vocab_size, (SMALL_LM_B, n), generator=g)
              for n in (SMALL_LM_N, SMALL_LM_T0, SMALL_LM_STEPS)))


def _small_ssm_rank(rank, world, device):
    """One rank of every small f32 recurrent model on ``device``:
    ``voltage`` and ``prism`` forward logits (the state hand-off), sharded
    decode steps, greedy tokens under both."""
    import torch
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.models import transformer as tfm
    _exact_fp32()
    plans = (ExecutionPlan.voltage(seq_shards=world),
             ExecutionPlan.prism(L=SMALL_LM_L, cr=1.0, seq_shards=world))
    out = {}
    for label in SMALL_SSM:
        _, _, cfg, params, tokens, prompt, steps = _small_ssm(label)
        session = InferenceSession(cfg, _on(params, device), device=device,
                                   plans=list(plans))
        with torch.inference_mode():
            for p in plans:
                out[f"{label}/fwd/{p.mode}"] = tfm.forward_lm(
                    session.params, {"tokens": tokens.to(device)}, cfg,
                    p.to_exchange_config())[0].cpu()
        out[f"{label}/decode"] = _decode_steps(
            session.params, cfg, plans[0].to_exchange_config(), steps,
            device)
        for p in plans:
            out[f"{label}/gen/{p.mode}"] = session.generate(
                prompt, SMALL_LM_NEW, plan=p).cpu()
    return {k: v.numpy() for k, v in out.items()}


def phase_small_ssm_reference() -> None:
    """The small f32 recurrent models — hymba at G 5 (10/2 heads, dh 64,
    n_heads·hd = d) and a two-group xLSTM — on the card against the same weights on the CPU.
    In one process: the ``local`` forward, 12 decode steps (hymba's
    attention through the flash-decode kernel) ≤ 1e-4, greedy tokens
    exact, and the slot pool (2 slots, 3 requests: one slot re-admitted)
    token-exact against B 1 ``generate``.  On 2 ranks on the card against
    2 ranks on the CPU: ``voltage`` and ``prism`` forward logits (the
    state hand-off; hymba's segment means and PRISM attention), 12 sharded
    decode steps ≤ 1e-4, greedy tokens exact under both."""
    import numpy as np
    import torch
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.api.generation import generate
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import ServingRuntime
    t0 = time.perf_counter()
    local = ExecutionPlan.local()
    xcfg = local.to_exchange_config()
    worst = {}
    for label in SMALL_SSM:
        arch, reduced, cfg, params, tokens, prompt, steps = _small_ssm(label)
        side = {}
        for dev in ("cpu", "cuda"):
            p = _on(params, dev)
            r = side[dev] = {}
            with torch.inference_mode():
                r["fwd"] = tfm.forward_lm(p, {"tokens": tokens.to(dev)}, cfg,
                                          xcfg)[0].cpu()
            r["gen"] = generate(p, prompt.to(dev), SMALL_LM_NEW, cfg,
                                xcfg).cpu()
            r["decode"] = _decode_steps(p, cfg, xcfg, steps, dev)
        cpu, gpu = side["cpu"], side["cuda"]
        for key in ("fwd", "decode"):
            err = worst[f"{label}/{key}"] = (gpu[key] - cpu[key]).abs().max(
            ).item()
            if not err <= 1e-4:
                raise AssertionError(f"small f32 {label} {key}: card vs CPU "
                                     f"differ by {err:.3e} > 1e-4")
        if not torch.equal(gpu["gen"], cpu["gen"]):
            raise AssertionError(f"small f32 {label}: card tokens differ "
                                 f"from the CPU's")
        session = InferenceSession(cfg, _on(params, "cuda"), device="cuda",
                                   plans=[local])
        session.profile(backend="simulated")
        rng = np.random.RandomState(5)
        prompts = [rng.randint(0, cfg.vocab_size, n) for n in (5, 11, 3)]
        rt = ServingRuntime(session, n_slots=2, chunk=4, max_len=32)
        reqs = [rt.submit(q, 10, seed=i) for i, q in enumerate(prompts)]
        done = {c.request_id: np.asarray(c.tokens) for c in rt.run()}
        if rt.stats["admitted"] != 3:
            raise AssertionError(f"small f32 {label}: {rt.stats['admitted']}"
                                 f" admissions, want 3")
        for q, req in zip(prompts, reqs):
            want = session.generate(np.asarray(q, np.int32)[None], 10,
                                    plan=local).cpu().numpy()[0]
            if not np.array_equal(done[req.id], want):
                raise AssertionError(f"small f32 {label}: the slot pool's "
                                     f"tokens differ from B 1 generate")
    ranks = _both_devices(_small_ssm_rank, LM_P)
    want = ranks["cpu"][0]
    seq = {}
    for label in SMALL_SSM:
        for key in ("fwd/voltage", "fwd/prism", "decode"):
            k = f"{label}/{key}"
            seq[k] = max(float(np.abs(r[k] - want[k]).max())
                         for r in ranks["cuda"])
            if not seq[k] <= 1e-4:
                raise AssertionError(f"small f32 {k}: {LM_P} ranks on the "
                                     f"card vs {LM_P} on the CPU differ by "
                                     f"{seq[k]:.3e} > 1e-4")
        for key in ("gen/voltage", "gen/prism"):
            k = f"{label}/{key}"
            for r in ranks["cuda"] + ranks["cpu"]:
                if not np.array_equal(r[k], want[k]):
                    raise AssertionError(f"small f32 {k}: greedy tokens "
                                         f"differ across ranks/devices")
    for label in SMALL_SSM:
        arch, reduced = SMALL_SSM[label]
        print(f"[reference] reduced f32 {arch} ({label}: {reduced}) on the "
              f"card vs the CPU: max |logit diff| local "
              f"{worst[label + '/fwd']:.2e}, {SMALL_LM_STEPS} decode steps "
              f"{worst[label + '/decode']:.2e} (tol 1e-4), greedy tokens "
              f"exact, the slot pool (2 slots, 3 requests, one slot "
              f"re-admitted) token-exact against B 1 generate; {LM_P} ranks "
              f"on the card vs {LM_P} on the CPU: voltage "
              f"{seq[label + '/fwd/voltage']:.2e}, prism(L={SMALL_LM_L}) "
              f"{seq[label + '/fwd/prism']:.2e}, {SMALL_LM_STEPS} sharded "
              f"decode steps {seq[label + '/decode']:.2e}, greedy tokens "
              f"exact under both", flush=True)
    print(f"[reference] the small recurrent models: "
          f"{time.perf_counter() - t0:.1f} s with rank start-up", flush=True)


def serve_pool(session, card: str, note: str, n_requests: int, n_slots: int,
               chunk: int) -> int:
    """``session``'s arch served through the slot pool (``ServingRuntime``,
    ``n_slots`` slots): ``n_requests`` greedy requests of PROMPT_T + N_NEW
    tokens at once (more requests than slots: slots are re-admitted),
    each held against the B 1 ``generate`` of its prompt under the plan
    that served it (token-exact, or diverging only where the B 1 logits
    sit within FLEET_TIE_TOL of a tie), flash-decode launches asserted =
    the attention layers × (chunk steps + the prompts' decode-loop
    prefill steps) → launches: ``step``, the pool's steps at B
    ``n_slots``, and ``prefill``, the admissions' B 1 decode-loop prefill
    (the two add up to the launches counted)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.serving import ServingRuntime
    cfg = session.cfg
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, PROMPT_T)
               for _ in range(n_requests)]
    rt = ServingRuntime(session, n_slots=n_slots, chunk=chunk,
                        max_len=PROMPT_T + N_NEW)
    before = rt.stats_snapshot()
    flash_decode.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [rt.submit(p, N_NEW, seed=i) for i, p in enumerate(prompts)]
    done = {c.request_id: c for c in rt.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_decode.launches
    after = rt.stats_snapshot()
    steps = (after["chunks"] - before["chunks"]) * chunk
    attn = 0 if cfg.family == "ssm" else cfg.n_layers
    want = attn * (steps + n_requests * PROMPT_T)
    if launches != want:
        raise AssertionError(f"serve {cfg.name}: flash_decode launched "
                             f"{launches} times, want {want}")
    admitted = after["admitted"] - before["admitted"]
    if admitted != n_requests:
        raise AssertionError(f"serve {cfg.name}: {admitted} admissions, "
                             f"want {n_requests}")
    comps = {i: done[r.id] for i, r in enumerate(reqs)}
    exact, div = _fleet_ref_tokens(session, comps, prompts)
    lat = [c.latency_ms for c in comps.values()]
    plans = sorted({c.plan_key for c in comps.values()})
    print(f"[serve] {cfg.name}{note} slot pool ({n_slots} slots, chunk "
          f"{chunk}, plans {plans}): {len(prompts)} requests x {N_NEW} "
          f"greedy tokens after {PROMPT_T}-token prompts ({admitted} "
          f"admissions, {admitted - n_slots} into a re-admitted slot) in "
          f"{wall:.2f} s: {len(prompts) / wall:.2f} requests/s, "
          f"{len(prompts) * N_NEW / wall:.1f} tokens/s; latency p50 "
          f"{np.percentile(lat, 50):.0f} ms p99 {np.percentile(lat, 99):.0f}"
          f" ms; {_divergence(exact, len(prompts), div)} B 1 generate; "
          f"flash_decode launches {launches} = {attn} attention layers x "
          f"({steps} chunk steps + {n_requests} x {PROMPT_T} prefill steps) "
          f"[{card}]", flush=True)
    return dict(step=attn * steps, prefill=attn * n_requests * PROMPT_T)


def phase_ssm_arch(card: str, arch: str) -> dict:
    """``arch`` at full width and depth (at most ARCH_LAYERS[arch] layers),
    bf16, random weights from seed 0:
    a measured profile at B 1 and 4 on the H100 presets, decide at B 1, 8
    and 32, greedy ``generate`` of [4, 32] + 16 under ``local`` (the
    kernel time and the device's idle share from ``torch.profiler``) and
    ``prism_sim``, both prefilling by the decode loop, flash-decode
    launches asserted (hymba: every step of every layer; xLSTM: none), the
    kernel time and the device's idle share over SSM_PROFILE_STEPS
    ``local`` decode steps after the prompt, then the slot pool with a
    slot re-admitted, and the peak memory → (the generates' launches,
    local decode ms a step, the slot pool's launches at its steps and at
    its admissions' prefill)."""
    import dataclasses
    import gc
    import torch
    from repro_torch.api import ExecutionPlan, InferenceSession
    from repro_torch.api import generation as gen_api
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models import transformer as tfm
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=min(
        full.n_layers, ARCH_LAYERS.get(arch, full.n_layers)))
    params = registry.init_params(cfg, seed=0, device="cuda")
    plans = [ExecutionPlan.local(), ExecutionPlan.prism_sim(L=4, cr=9.9)]
    session = InferenceSession(cfg, params, device="cuda", plans=plans)
    n_params = sum(t.numel() for t in _leaves(params))
    del params
    torch.cuda.synchronize()
    s = cfg.ssm
    if cfg.family == "hybrid":
        fam = (f"{cfg.n_layers} layers of attention ({cfg.n_heads}/"
               f"{cfg.n_kv_heads} heads, dh {cfg.hd}) beside a Mamba mixer "
               f"(d_inner {s.expand * cfg.d_model}, state {s.state_size}, "
               f"conv {s.conv_width}), d_ff {cfg.d_ff}")
    else:
        G = cfg.n_layers // s.slstm_every
        fam = (f"{G} groups of {s.slstm_every - 1} mLSTM blocks "
               f"({s.mlstm_heads} heads of "
               f"{int(cfg.d_model * s.proj_factor) // s.mlstm_heads}) and "
               f"one sLSTM block, no attention")
    depth = ("depth" if cfg.n_layers == full.n_layers
             else f"{cfg.n_layers} of {full.n_layers} layers")
    print(f"[session] {arch} full width and {depth} ({fam}, d "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype}; "
          f"{n_params / 1e9:.2f} B parameters, {registry.weight_bytes(cfg) / 1e9:.2f} GB, drawn on "
          f"the card from seed 0) built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t1 = time.perf_counter()
    pm, scale, raw = measured_profile(
        session, dict(batches=(1, 4), crs=(9.9,), bandwidths_mbps=(400.0,)),
        iters=2)
    print_measured(arch, pm, scale, raw, card,
                   f" (profile {time.perf_counter() - t1:.1f} s)")
    for B in DECIDE_BATCHES:
        d = session.decide(B)
        print(f"[decide] {arch} B={B} @ {session.bandwidth:g} Mbps → "
              f"{d.mode}" + (f" CR={d.cr:g}" if d.cr else "")
              + f" ({d.expected.per_sample_ms:.2f} ms/sample, measured on "
              f"{pm.hardware.name})", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (PROMPT_B, PROMPT_T),
                           generator=g, device="cuda")
    steps = PROMPT_T + N_NEW - 1                 # the decode-loop prefill
    attn = 0 if cfg.family == "ssm" else cfg.n_layers
    launches, decode_ms = drive_generate(session, prompt, "local", steps,
                                         card, breakdown=False, per_step=attn)
    xcfg = session.plans["local"].to_exchange_config()
    with torch.inference_mode():
        cache = tfm.init_decode_cache(cfg, PROMPT_B, PROMPT_T + N_NEW,
                                      device="cuda")
        logits, primed = gen_api.prefill_by_decode(session.params, prompt,
                                                   cache, cfg, xcfg)
        tok = gen_api.sample_token(logits, None)[:, 0:1]
        copies = [_clone(primed) for _ in range(2)]

    def decode(c):
        with torch.inference_mode():
            return gen_api.decode_scan(session.params, c, tok, PROMPT_T,
                                       None, cfg, xcfg, 0.0,
                                       SSM_PROFILE_STEPS)[0]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    decode(copies[0])
    torch.cuda.synchronize()
    print_breakdown(f"{arch} local: {SSM_PROFILE_STEPS} decode steps of a",
                    lambda: decode(copies[1]),
                    (time.perf_counter() - t1) * 1e3)
    del cache, primed, copies
    key = next(k for k in session.plans if k != "local")
    launches += drive_generate(session, prompt, key, steps, card,
                               breakdown=False, per_step=attn)[0]
    pool = serve_pool(session, card, "", SSM_SERVE_REQUESTS, SSM_SERVE_SLOTS,
                      SSM_SERVE_CHUNK)
    if not attn:
        print(f"[generate] {arch}: no kernel of the port runs on its path "
              f"(no softmax attention; its mixers are plain torch, as they "
              f"are plain jnp in the JAX package); flash_decode launches 0, "
              f"asserted", flush=True)
    peak = torch.cuda.max_memory_allocated()
    print(f"[memory] {arch}: peak allocated {peak / 1e9:.2f} GB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB "
          f"[{card}]", flush=True)
    del session
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, decode_ms=decode_ms,
                pool_step=pool["step"], pool_prefill=pool["prefill"])


def ssm_seq_bytes(cfg, plan: str, P: int, rank: int) -> dict:
    """What rank ``rank``'s staged calls receive in one ``forward_lm`` of
    [LM_B, LM_N] under ``plan``, from shapes: hymba's attention K and V
    (in full under ``voltage``, L means a partition under ``prism``), one
    call a layer; on a rank after the first one ``state`` message a
    mixer (Mamba: h [B, di, S] f32 and the conv tail [B, W − 1, di] in the
    model dtype; mLSTM: C, n, m f32; sLSTM: c, n, h, m f32); the last
    logits' broadcast."""
    if plan == "local":
        return dict(payload=0, meta=0, state=0, calls=0)
    s, B, d = cfg.ssm, LM_B, cfg.d_model
    w = cfg.torch_dtype.itemsize
    if cfg.family == "hybrid":
        di = s.expand * d
        kv = B * cfg.n_kv_heads * cfg.hd * 2 * w
        n = LM_L if plan == "prism" else LM_N // P
        payload = cfg.n_layers * (P - 1) * n * kv
        states = [B * di * (s.state_size * 4 + (s.conv_width - 1) * w)] \
            * cfg.n_layers
        exchanges = cfg.n_layers
    else:
        H = s.mlstm_heads
        dh = int(d * s.proj_factor) // H
        states = ([B * H * (dh * dh + dh + 1) * 4] * (s.slstm_every - 1)
                  + [4 * B * d * 4]) * (cfg.n_layers // s.slstm_every)
        payload, exchanges = 0, 0
    received = rank > 0
    return dict(payload=payload, meta=0, state=sum(states) * received,
                calls=exchanges + len(states) * received + 1)


def _ssm_seq_rank(rank, world):
    """One rank of hymba-1.5b and then xlstm-350m at full width, cut to
    SSM_SEQ's layers, on the shared card: the ``last_only`` forward of
    [LM_B, LM_N] under each plan (payload, meta and state bytes and calls
    asserted against the shapes; hymba's segment means and PRISM
    attention launches asserted), then greedy ``generate`` of [PROMPT_B,
    PROMPT_T] + N_NEW under ``voltage`` (flash-decode launches asserted;
    tokens equal on both ranks, their agreement with ``local`` counted;
    no state moved), and the same weights in f32 under ``local`` and
    ``voltage``, token-exact, with their launches."""
    import dataclasses
    import gc
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
    res = {}
    for arch, cut in SSM_SEQ:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), **cut)
        params = registry.init_params(cfg, seed=0, device="cuda")
        sums = torch.stack([leaf.double().sum() for leaf in
                            _leaves(params)]).cpu().numpy().tobytes()
        if group.broadcast_object(sums) != sums:
            raise AssertionError(f"rank {rank}: {arch} weights differ from "
                                 f"rank 0's")
        plans = {"local": ExecutionPlan.local(),
                 "voltage": ExecutionPlan.voltage(seq_shards=world),
                 "prism": ExecutionPlan.prism(
                     L=LM_L, cr=LM_N / (LM_L * world), seq_shards=world)}
        session = InferenceSession(cfg, params, device="cuda",
                                   plans=list(plans.values()))
        del params
        build_s = time.perf_counter() - t0
        attn = 0 if cfg.family == "ssm" else cfg.n_layers
        g = torch.Generator(device="cuda").manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (LM_B, LM_N), generator=g,
                               device="cuda")
        prompt = torch.randint(0, cfg.vocab_size, (PROMPT_B, PROMPT_T),
                               generator=g, device="cuda")

        def forward(key):
            with torch.inference_mode():
                return tfm.forward_lm(session.params, {"tokens": tokens},
                                      cfg, plans[key].to_exchange_config(),
                                      last_only=True)[0]
        for key in plans:                               # warm-up
            forward(key)
        fwd = {}
        for key in plans:                               # the main path
            segment_means.launches = prism_attention.launches = 0
            last, ms, staged, calls, _ = _timed(lambda: forward(key), group)
            counts = (segment_means.launches, prism_attention.launches)
            st = group.stats
            got = dict(payload=st.payload_bytes, meta=st.meta_bytes,
                       state=st.state_bytes, calls=st.calls)
            want = ssm_seq_bytes(cfg, key, world, rank)
            if got != want:
                raise AssertionError(f"rank {rank} {arch} {key}: staged "
                                     f"{got}, the shapes give {want}")
            n = attn * (key == "prism")
            if counts != (n, n):
                raise AssertionError(f"rank {rank} {arch} {key}: "
                                     f"(segment_means, prism_attention) "
                                     f"launched {counts}, want {(n, n)}")
            if not torch.isfinite(last).all():
                raise AssertionError(f"rank {rank} {arch} {key}: last "
                                     f"logits not finite")
            both = group.all_gather(last, kind="meta")
            if not torch.equal(both[0], both[1]):
                raise AssertionError(f"{arch} {key}: last logits differ "
                                     f"between ranks")
            runs = [(ms, staged)] + [_timed(lambda: forward(key), group)[1:3]
                                     for _ in range(2)]
            fwd[key] = dict(got, counts=counts,
                            ms=statistics.median(r[0] for r in runs),
                            staged_ms=statistics.median(r[1] for r in runs))
        want = session.generate(prompt, N_NEW, plan=plans["local"])
        session.generate(prompt, 2, plan=plans["voltage"])    # warm-up
        flash_decode.launches = 0                            # the main path
        out, w, sd, cd, md = _timed(
            lambda: session.generate(prompt, N_NEW, plan=plans["voltage"]),
            group)
        launches, state = flash_decode.launches, group.stats.state_bytes
        steps = PROMPT_T + N_NEW - 1                 # decode-loop prefill
        if launches != steps * attn or state:
            raise AssertionError(f"rank {rank} {arch} voltage generate: "
                                 f"flash_decode launched {launches} times "
                                 f"(want {steps} x {attn}), {state} state "
                                 f"bytes (want 0)")
        both = group.all_gather(out, kind="meta")
        if not torch.equal(both[0], both[1]):
            raise AssertionError(f"{arch} voltage: the ranks drew different "
                                 f"tokens")
        agree = (out == want).float().mean().item()
        peak = torch.cuda.max_memory_allocated()
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params32 = _cast(session.params, torch.float32)
        del session
        gc.collect()
        torch.cuda.empty_cache()
        s32 = InferenceSession(cfg32, params32, device="cuda",
                               plans=[plans["local"], plans["voltage"]])
        del params32
        flash_decode.launches = 0                            # the main path
        want32 = s32.generate(prompt, N_NEW, plan=plans["local"])
        local32 = flash_decode.launches
        flash_decode.launches = 0                            # the main path
        got32 = s32.generate(prompt, N_NEW, plan=plans["voltage"])
        volt32 = flash_decode.launches
        if not torch.equal(got32, want32):
            raise AssertionError(f"rank {rank} {arch} f32: voltage tokens "
                                 f"{got32.tolist()} differ from local's "
                                 f"{want32.tolist()}")
        if (local32, volt32) != (steps * attn,) * 2:
            raise AssertionError(f"rank {rank} {arch} f32: flash_decode "
                                 f"launched {local32} + {volt32} times, want"
                                 f" {steps} x {attn} each")
        res[arch] = dict(fwd=fwd, build_s=build_s, gen_s=w / 1e3,
                         gen_staged_s=sd / 1e3, gen_calls=cd, gen_merge=md,
                         launches=launches, agree=agree, local32=local32,
                         volt32=volt32, peak=peak)
        del s32
        gc.collect()
        torch.cuda.empty_cache()
    return res


def phase_ssm_seq(card: str) -> dict:
    """hymba-1.5b and xlstm-350m at full width, cut to SSM_SEQ's layers, on
    2 ranks sharing the card → launch totals over the ranks: segment means
    and PRISM attention (part 0 on rank 0, part 1 on rank 1) of hymba's
    ``prism`` forward, flash-decode's shard partials in the bf16 and f32
    ``voltage`` generates and its dense launches in the f32 ``local``
    one."""
    from repro_torch.configs import get_config
    from repro_torch.core.seq_group import spawn
    t0 = time.perf_counter()
    ranks = spawn(_ssm_seq_rank, LM_P, timeout=RANK_TIMEOUT_S)
    out = {}
    for arch, cut in SSM_SEQ:
        full = get_config(arch)
        r0, r1 = ranks[0][arch], ranks[1][arch]
        depth = cut.get("n_layers", full.n_layers)
        print(f"[ssm-seq] {arch} full width, {depth} of {full.n_layers} "
              f"layers{' (cut for time)' if depth < full.n_layers else ''}, "
              f"bf16, random weights from seed 0, equal on both ranks; "
              f"{LM_P} ranks sharing the card, gloo staged through host "
              f"memory, B {LM_B}; built in {r0['build_s']:.1f} s, peak "
              f"{r0['peak'] / 1e9:.2f} GB a rank", flush=True)
        for key, f in r0["fwd"].items():
            f1 = r1["fwd"][key]
            share = f1["staged_ms"] / f1["ms"] if f1["ms"] else 0.0
            sm, pa = f["counts"]
            print(f"[ssm-seq] {arch} forward_lm(last_only) {key}: B={LM_B} "
                  f"N={LM_N}, rank 0 {f['ms']:.2f} ms (staged "
                  f"{f['staged_ms']:.2f} ms), rank 1 {f1['ms']:.2f} ms "
                  f"(staged {f1['staged_ms']:.2f} ms, {share:.1%}, the wait "
                  f"for rank 0's states included); calls {f['calls']} / "
                  f"{f1['calls']}; received a rank (rank 0 / rank 1): "
                  f"payload {f['payload'] / 1e6:.4f} / "
                  f"{f1['payload'] / 1e6:.4f} MB, meta {f['meta']} / "
                  f"{f1['meta']} B, state {f['state'] / 1e6:.4f} / "
                  f"{f1['state'] / 1e6:.4f} MB, = the shapes' count; "
                  f"segment_means {sm}, prism_attention {pa} launches a rank"
                  f" (median of 3) [{card}]", flush=True)
        print(f"[ssm-seq] {arch} generate voltage [{PROMPT_B}, {PROMPT_T}] "
              f"+ {N_NEW} (decode-loop prefill, every rank a full copy of "
              f"the states): {r0['gen_s']:.3f} s ({r0['gen_staged_s']:.3f} s"
              f" staged in {r0['gen_calls']} calls, "
              f"{r0['gen_merge'] / 1e3:.1f} kB of merge partials, no state "
              f"bytes), the same tokens on both ranks, {r0['agree']:.0%} of "
              f"them local's in bf16 (rank 1: {r1['agree']:.0%}); the same "
              f"weights in f32 token-exact against local on both ranks; "
              f"flash_decode launches {r0['launches']} a rank (f32: local "
              f"{r0['local32']}, voltage {r0['volt32']}) [{card}]",
              flush=True)
        if full.family == "hybrid":
            out["segment_means"] = sum(r[arch]["fwd"]["prism"]["counts"][0]
                                       for r in ranks)
            for p in range(LM_P):
                out[f"prism_attention_{p}"] = \
                    ranks[p][arch]["fwd"]["prism"]["counts"][1]
            out["shard"] = sum(r[arch]["launches"] for r in ranks)
            out["shard_f32"] = sum(r[arch]["volt32"] for r in ranks)
            out["decode_f32"] = sum(r[arch]["local32"] for r in ranks)
    print(f"[ssm-seq] {time.perf_counter() - t0:.1f} s with rank start-up",
          flush=True)
    return out


def ssm_kernel_rows(sa: dict, sk: dict, ss: dict, replaces: dict,
                    keys: tuple) -> list:
    """The kernels line's rows of hymba-1.5b: one a shape its main paths
    launch a kernel at, its numbers from ``phase_ssm_kernels`` (``sk``)
    and its launches from ``[arch]`` (``sa``) or ``[ssm-seq]`` (``ss``)."""
    from repro_torch.configs import get_config
    c = get_config(HYMBA)
    H, Hk, dh = c.n_heads, c.n_kv_heads, c.hd
    S, np_ = PROMPT_T + N_NEW, LM_N // LM_P
    heads = f"{H}/{Hk} heads dh={dh} (G {H // Hk})"
    shard = (f"rank 1 of {LM_P}: B={PROMPT_B} Sp={S // LM_P} of S={S}, "
             f"offset {S // LM_P}, {heads}")
    rows = [
        ("flash_decode", sa[HYMBA]["launches"], sk["decode"],
         f"{HYMBA} decode: bf16 B={PROMPT_B} S={S} {heads}; launches: "
         f"`[arch]` local and prism_sim generate"),
        ("flash_decode", sa[HYMBA]["pool_step"], sk["pool"],
         f"{HYMBA} decode: bf16 B={SSM_SERVE_SLOTS} S={S} {heads}, each "
         f"slot its own length (a [B] cache index; 40/17 valid); launches: "
         f"`[arch]`'s slot pool steps"),
        ("flash_decode", sa[HYMBA]["pool_prefill"], sk["prefill"],
         f"{HYMBA} decode: bf16 B=1 S={S} {heads}, {PROMPT_T} valid; "
         f"launches: `[arch]`'s slot pool admissions (the B 1 decode-loop "
         f"prefill)"),
        ("flash_decode", ss["decode_f32"], sk["decode_f32"],
         f"{HYMBA} decode: f32 B={PROMPT_B} S={S} {heads}; launches: "
         f"`[ssm-seq]`'s f32 local generate"),
        ("flash_decode", ss["shard"], sk["shard"],
         f"{HYMBA} shard partial, bf16 {shard}; launches: `[ssm-seq]`'s "
         f"voltage generate"),
        ("flash_decode", ss["shard_f32"], sk["shard_f32"],
         f"{HYMBA} shard partial, f32 {shard}; launches: `[ssm-seq]`'s f32 "
         f"voltage generate"),
        ("segment_means", ss["segment_means"], sk["seg"],
         f"{HYMBA} prism forward per rank: K and V bf16 [{LM_B}, {np_}, "
         f"{Hk}·{dh}] L={LM_L}")]
    rows += [("prism_attention", ss[f"prism_attention_{p}"], sk[f"prism_{p}"],
              f"{HYMBA} prism forward, rank {p}: bf16 [{LM_B}, {np_}] "
              f"{heads} causal L={LM_L} part {p}") for p in range(LM_P)]
    return [{"name": kname, "route": "cuda",
             "source": f"src/repro_torch/kernels/{kname}/csrc/{kname}.cu",
             "replaces": replaces[kname], "launches": n, "shape": shape,
             **{k: t[k] for k in keys}} for kname, n, t, shape in rows]


# ---------------------------------------------------------------------------
# training: the autograd functions, a small reference, llama3.2-1b
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_N, TRAIN_STEPS = 4, 512, 5          # [train]: full depth
TRAIN_SEQ_LAYERS, TRAIN_SEQ_STEPS = 4, 2            # [train-seq], 2 ranks
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1)           # [train-reference]
TRAIN_REF_STEPS, TRAIN_REF_N = 2, 32
# (B, Np, H, Hk, dh, P, L, part, causal, masked): llama3.2-1b's prism train
# shape (rank 1 of 2 at N 512) and ViT-B/16's (197 tokens padded to 200,
# rank 1's 100 with the 3 pads, L 20)
TRAIN_KERNEL_SHAPES = {
    "llama": (LM_B, LM_N // LM_P, N_HEADS, N_KV, 64, LM_P, LM_L, 1, True,
              False),
    "vit": (VIT_B, 100, 12, 12, 64, VIT_P, VIT_L, 1, False, True)}


def graph_ms(fn) -> float:
    """Median device ms of one ``fn()``, captured in a CUDA graph with its
    autograd work (``time_ms`` with one argument set: inputs warm in
    L2)."""
    return time_ms(lambda: fn(), [()])


def _grad_errs(label, names, got, want, dtype) -> float:
    """Each gradient of the kernel route (its forward, the explicit
    backward) vs autograd of the plain version → the worst relative max
    error; raises past tolerance: f32 1e-5; bf16 one bf16 rounding step at
    the largest value (2^-7 of it: both sides round one f32 gradient whose
    last bits differ)."""
    import torch
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    worst = 0.0
    for name, a, b in zip(names, got, want):
        err = rel_err(a, b)
        if not (err <= tol and torch.isfinite(a).all()):
            raise AssertionError(f"{label} d{name}: relative error {err:.3e}"
                                 f" > {tol:g} (or not finite)")
        worst = max(worst, err)
    return worst


def train_kernel_case(shape: str, dtype, seed: int) -> dict:
    """The inputs of one PRISM step at ``TRAIN_KERNEL_SHAPES[shape]`` as
    leaves that require grad: q, K, V of the partition and the gathered
    [P, 2, B, L, Hk, dh] means (the kernel reads its strided view), the
    key mask and the means' counts (ViT: rank 1 holds the 3 pads)."""
    import torch
    B, Np, H, Hk, dh, P, L, part, causal, masked = TRAIN_KERNEL_SHAPES[shape]
    g = torch.Generator(device="cuda").manual_seed(seed)

    def leaf(*s):
        return torch.randn(*s, generator=g, device="cuda").to(
            dtype).requires_grad_()
    q, k, v = leaf(B, Np, H, dh), leaf(B, Np, Hk, dh), leaf(B, Np, Hk, dh)
    gathered = leaf(P, 2, B, L, Hk, dh)
    mask = counts = None
    seg = Np // L
    if masked:
        mask = torch.ones(B, Np, dtype=torch.bool, device="cuda")
        mask[:, -3:] = False
        counts = torch.full((B, P, L), float(seg), device="cuda")
        counts[:, part, -1] = seg - 3
    return dict(q=q, k=k, v=v, gathered=gathered, mask=mask, counts=counts,
                part=part, seg=seg, causal=causal, L=L)


def _prism_routes(c):
    """(kernel route through the autograd function, plain version under
    autograd) of the case's PRISM attention."""
    from repro_torch.kernels.prism_attention import (build_mean_bias,
                                                     prism_attention_op,
                                                     prism_attention_ref)
    q, k, v = c["q"], c["k"], c["v"]
    B, P, L = q.shape[0], c["gathered"].shape[0], c["L"]

    def means():
        return c["gathered"].permute(1, 2, 0, 3, 4, 5)

    def kernel():
        km, vm = means()
        return prism_attention_op(q, k, v, km, vm, c["part"], c["seg"],
                                  causal=c["causal"], kv_mask=c["mask"],
                                  mean_counts=c["counts"])

    def plain():
        km, vm = means()
        bias = build_mean_bias(B, P, L, c["part"], c["seg"],
                               causal=c["causal"], mean_counts=c["counts"],
                               device=q.device)
        return prism_attention_ref(q, k, v, km.flatten(1, 2),
                                   vm.flatten(1, 2), bias,
                                   causal=c["causal"], kv_mask=c["mask"])
    return kernel, plain


def _seg_routes(c):
    """(kernel route, plain version) of the case's K and V segment means
    (one launch; the counts from the key mask)."""
    import torch
    from repro_torch.kernels.segment_means import (segment_means_kv_op,
                                                   segment_means_ref)
    k, v, mask, L = c["k"], c["v"], c["mask"], c["L"]
    B, Np = k.shape[:2]

    def kernel():
        return segment_means_kv_op(k, v, L, mask)[0]

    def plain():
        return torch.stack([segment_means_ref(t.reshape(B, Np, -1), L,
                                              mask)[0] for t in (k, v)]
                           ).reshape(2, B, L, *k.shape[2:])
    return kernel, plain


def _pairs(c) -> int:
    """(query, key) pairs the PRISM step computes: each query's unmasked
    local keys (causal: those at or before it) and the means it sees."""
    B, Np = c["q"].shape[:2]
    P, L = c["gathered"].shape[0], c["L"]
    seen_means = (c["part"] if c["causal"] else P - 1) * L
    if c["causal"]:
        return B * (Np * (Np + 1) // 2 + Np * seen_means)
    keys = Np - (3 if c["mask"] is not None else 0)
    return B * Np * (keys + seen_means)


def check_train_kernels(shape: str, dtype) -> dict:
    """Both autograd functions at ``shape`` in ``dtype``: forward output
    and every gradient of the kernel route vs autograd of the plain
    version on the same inputs and cotangent → errors."""
    import torch
    c = train_kernel_case(shape, dtype, seed=41)
    leaves = (c["q"], c["k"], c["v"], c["gathered"])
    out = {}
    for name, routes, wrt, names in (
            ("prism_attention", _prism_routes(c), leaves,
             ("q", "k", "v", "means")),
            ("segment_means", _seg_routes(c), leaves[1:3], ("k", "v"))):
        kernel, plain = routes
        got = kernel()
        g = torch.randn(got.shape, generator=torch.Generator(
            device="cuda").manual_seed(7), device="cuda").to(dtype)
        grads = torch.autograd.grad(got, wrt, g)
        torch.cuda.synchronize()
        want = plain()
        fwd = rel_err(got, want)
        step = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
        if not fwd <= step:
            raise AssertionError(f"{name} {shape} {dtype}: forward relative "
                                 f"error {fwd:.3e} > {step:g}")
        bwd = _grad_errs(f"{name} {shape} {dtype}", names, grads,
                         torch.autograd.grad(want, wrt, g), dtype)
        out[name] = dict(fwd=fwd, bwd=bwd, max_abs_err=(
            got.float() - want.float()).abs().max().item())
    return out


def time_train_kernels(shape: str) -> dict:
    """bf16 at ``shape``: each kernel's forward, its explicit backward
    alone, the plain version's forward + backward under autograd, and a
    yardstick's forward + backward (sdpa over [K ‖ means] with the bias as
    a float mask; ``mean()`` of K and V stacked), each captured in a CUDA
    graph (``graph_ms``: host launches excluded, inputs warm in L2);
    the backward's bound (every input and the cotangent read once, every
    gradient written once; PRISM: 2·H·(3·dh + 2·dv) flops a (query, key)
    pair it recomputes: scores, dp, dq, dk, dv)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.prism_attention import build_mean_bias
    from repro_torch.kernels.prism_attention.ops import prism_attention_grads
    from repro_torch.kernels.segment_means.ops import _token_grad
    dtype = torch.bfloat16
    c = train_kernel_case(shape, dtype, seed=43)
    q, k, v, gm = c["q"], c["k"], c["v"], c["gathered"]
    B, Np, H, dh = q.shape
    Hk, P, L = k.shape[2], gm.shape[0], c["L"]
    out = {}
    kernel, plain = _prism_routes(c)
    go = torch.randn(B, Np, H, dh, device="cuda").to(dtype)
    bias = build_mean_bias(B, P, L, c["part"], c["seg"], causal=c["causal"],
                           mean_counts=c["counts"], device="cuda")
    km, vm = gm.detach().permute(1, 2, 0, 3, 4, 5)
    leaves = (q, k, v, gm)
    with torch.no_grad():
        fwd = graph_ms(kernel)
        bwd = graph_ms(lambda: prism_attention_grads(
            q, k, v, km, vm, bias, go, causal=c["causal"], scale=None,
            softcap=None, kv_mask=c["mask"], q_offset=0))
    keys = torch.where(c["mask"], 0.0, -1e30) if c["mask"] is not None \
        else torch.zeros(B, Np, device="cuda")
    full = torch.cat([keys, bias], dim=1).to(dtype)[:, None, None, :]
    if c["causal"]:
        tri = torch.ones(Np, Np, dtype=torch.bool, device="cuda").tril()
        local = torch.where(tri, 0.0, -1e30).to(dtype)
        full = torch.cat([local.expand(B, 1, Np, Np),
                          full[..., Np:].expand(B, 1, Np, P * L)], dim=-1)
    else:
        full = full.expand(B, 1, Np, Np + P * L)

    def sdpa():
        kk = torch.cat([k, gm[:, 0].permute(1, 0, 2, 3, 4).flatten(1, 2)], 1)
        vv = torch.cat([v, gm[:, 1].permute(1, 0, 2, 3, 4).flatten(1, 2)], 1)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
            attn_mask=full, enable_gqa=True)
    pairs = _pairs(c)
    moved = 2 * nbytes(q, k, v, gm) + nbytes(go, bias, c["mask"])
    b_ms, b_by = roofline(moved, 2 * H * 5 * dh * pairs, dtype)
    out["prism_attention"] = dict(
        fwd_ms=fwd, bwd_ms=bwd,
        plain_ms=graph_ms(lambda: torch.autograd.grad(plain(), leaves,
                                                         go)),
        library_ms=graph_ms(lambda: torch.autograd.grad(
            sdpa(), (q, k, v, gm), go.transpose(1, 2))),
        bwd_bound_ms=b_ms, bwd_bound_by=b_by)
    skernel, splain = _seg_routes(c)
    gs = torch.randn(2, B, L, Hk, dh, device="cuda").to(dtype)
    counts = (torch.full((B, L), float(c["seg"]), device="cuda")
              if c["mask"] is None else
              c["mask"].reshape(B, L, -1).float().sum(-1))
    with torch.no_grad():
        sfwd = graph_ms(skernel)
        sbwd = graph_ms(lambda: _token_grad(
            gs.reshape(2, B, L, -1), Np, c["mask"], counts, dtype))
    s_moved = 2 * nbytes(k, v) + nbytes(gs, c["mask"])
    sb_ms, sb_by = roofline(s_moved, 2 * nbytes(k, v) // k.element_size(),
                            dtype)
    kv = (k, v)
    out["segment_means"] = dict(
        fwd_ms=sfwd, bwd_ms=sbwd,
        plain_ms=graph_ms(lambda: torch.autograd.grad(splain(), kv, gs)),
        library_ms=graph_ms(lambda: torch.autograd.grad(
            torch.stack(kv).reshape(2, B, L, -1, Hk, dh).mean(3), kv, gs)),
        bwd_bound_ms=sb_ms, bwd_bound_by=sb_by)
    return out


def phase_train_kernels(card: str) -> dict:
    """``[train-kernels]``: each autograd function on the card (kernel
    forward, explicit backward) against autograd of its plain version, f32
    and bf16, at llama's and ViT-B/16's shapes; times at bf16 → the timed
    rows by (kernel, shape)."""
    import torch
    timed = {}
    for shape in TRAIN_KERNEL_SHAPES:
        B, Np, H, Hk, dh, P, L, part, causal, masked = \
            TRAIN_KERNEL_SHAPES[shape]
        errs = {str(dt).split(".")[1]: check_train_kernels(shape, dt)
                for dt in (torch.float32, torch.bfloat16)}
        t = time_train_kernels(shape)
        for name in ("prism_attention", "segment_means"):
            e = {dt: errs[dt][name] for dt in errs}
            r = t[name]
            what = (f"q [{B}, {Np}, {H}, {dh}] over {Hk} KV heads, "
                    f"{'causal' if causal else 'masked'}, P {P} L {L} part "
                    f"{part}" if name == "prism_attention" else
                    f"K and V [{B}, {Np}, {Hk}·{dh}] L {L}"
                    + (" masked" if masked else ""))
            print(f"[train-kernels] {name} {shape}: {what}; forward err "
                  f"f32 {e['float32']['fwd']:.2e} bf16 "
                  f"{e['bfloat16']['fwd']:.2e}, gradients f32 "
                  f"{e['float32']['bwd']:.2e} (tol 1e-5) bf16 "
                  f"{e['bfloat16']['bwd']:.2e} (tol 2^-7 of the largest) | "
                  f"bf16 kernel forward {r['fwd_ms'] * 1e3:.2f} us, explicit "
                  f"backward {r['bwd_ms'] * 1e3:.2f} us (bound "
                  f"{r['bwd_bound_ms'] * 1e3:.2f} us, {r['bwd_bound_by']}), "
                  f"plain forward+backward {r['plain_ms'] * 1e3:.2f} us, "
                  + ("sdpa" if name == "prism_attention" else "mean()")
                  + f" forward+backward {r['library_ms'] * 1e3:.2f} us "
                  f"[{card}]", flush=True)
            timed[(name, shape)] = dict(r, max_abs_err=e["bfloat16"][
                "max_abs_err"])
    return timed


# --- [train-reference]: a small f32 llama on the card vs the CPU -----------

def _train_ref_batches(cfg, n: int):
    """``n`` batches of [SMALL_LM_B, TRAIN_REF_N] tokens and labels."""
    import torch
    g = torch.Generator().manual_seed(5)
    return [{k: torch.randint(0, cfg.vocab_size, (SMALL_LM_B, TRAIN_REF_N),
                              generator=g) for k in ("tokens", "labels")}
            for _ in range(n)]


def _train_ref_run(params, cfg, xcfg, device):
    """The summed gradient of the first batch (f32 leaves), then
    TRAIN_REF_STEPS train steps → numpy results on the CPU."""
    import torch
    from repro_torch.core.exchange import partitioned, seq_group_for
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.train_step import _grads_of, build_train_step
    from repro_torch.utils.tree import tree_leaves
    p = _on(params, device)
    batches = [_on(b, device) for b in _train_ref_batches(
        cfg, TRAIN_REF_STEPS)]
    loss, _, grads = _grads_of(p, batches[0], cfg, xcfg)
    if partitioned(xcfg):
        group = seq_group_for(xcfg)
        grads = group.all_reduce(grads, kind="grad")
        loss = group.all_reduce([loss[None]], kind="meta")[0][0]
    step = build_train_step(cfg, xcfg, OptConfig(**TRAIN_OPT))
    o, metrics = adamw_init(p), []
    for b in batches:
        p, o, m = step(p, o, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(loss=float(loss), metrics=metrics,
                grads=[g.float().cpu().numpy() for g in grads],
                params=[t.float().cpu().numpy() for t in tree_leaves(p)])


def _train_ref_rank(rank, world):
    """One rank of the small f32 llama, on the card and then on the CPU,
    under ``voltage`` and ``prism``: the summed gradient and two train
    steps, and the kernels' launches on the card."""
    from repro_torch.core.exchange import ExchangeConfig, ExchangeMode
    from repro_torch.kernels.prism_attention import prism_attention
    from repro_torch.kernels.segment_means import segment_means
    _exact_fp32()
    cfg, params = _small_llama()[:2]
    out = {}
    for mode in ("voltage", "prism"):
        xcfg = ExchangeConfig(ExchangeMode(mode), seq_axis="seq",
                              seq_shards=world, L=SMALL_LM_L)
        for device in ("cuda", "cpu"):
            before = (segment_means.launches, prism_attention.launches)
            out[f"{mode}/{device}"] = _train_ref_run(params, cfg, xcfg,
                                                     device)
            out[f"{mode}/{device}"]["launches"] = (
                segment_means.launches - before[0],
                prism_attention.launches - before[1])
    return out


def _leaf_errs(got, want) -> float:
    """Worst over leaves of max |got − want| / max |want|."""
    import numpy as np
    return max(float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                1e-30)
               for a, b in zip(got, want))


def _params_close(got, want, steps: int) -> tuple:
    """(share of elements within 1e-5, max |Δ|) of two runs' params; raises
    where an element moved further apart than AdamW's sign-flip bound
    (2 · lr a step: an element whose gradient sits near 0 may move the
    other way)."""
    import numpy as np
    d = np.concatenate([np.abs(a - b).ravel() for a, b in zip(got, want)])
    bound = 2 * steps * TRAIN_OPT["lr"] + 1e-5
    if not float(d.max()) <= bound:
        raise AssertionError(f"params differ by {d.max():.3e} > {bound:g}")
    share = float((d <= 1e-5).mean())
    if not share >= 0.99:
        raise AssertionError(f"only {share:.2%} of the params within 1e-5")
    return share, float(d.max())


def _check_ref(label, got, want) -> str:
    """Card vs CPU: loss and each step's loss and grad_norm ≤ 1e-5
    relative, the gradient ≤ 1e-4 of each leaf's largest value, the params
    after the steps as ``_params_close``."""
    g_err = _leaf_errs(got["grads"], want["grads"])
    if not g_err <= 1e-4:
        raise AssertionError(f"{label}: gradient off by {g_err:.3e} > 1e-4")
    m_err = max([abs(got["loss"] - want["loss"]) / abs(want["loss"])]
                + [abs(a[k] - b[k]) / abs(b[k])
                   for a, b in zip(got["metrics"], want["metrics"])
                   for k in ("loss", "grad_norm")])
    if not m_err <= 1e-5:
        raise AssertionError(f"{label}: loss / grad_norm off by {m_err:.3e}"
                             f" > 1e-5")
    share, worst = _params_close(got["params"], want["params"],
                                 TRAIN_REF_STEPS)
    return (f"{label}: gradient {g_err:.2e} of the largest (tol 1e-4), "
            f"losses and grad_norm {m_err:.2e} (tol 1e-5), params after "
            f"{TRAIN_REF_STEPS} steps {share:.2%} within 1e-5 (max "
            f"{worst:.2e})")


def phase_train_reference(card: str) -> None:
    """``[train-reference]``: the small f32 llama's gradient and 2 AdamW
    steps on the card against the same on the CPU's plain versions: one
    process ``local``, and 2 ranks under ``voltage`` and ``prism`` (the
    kernels' forward, the explicit backward, the gather's reduce-scattered
    cotangent); then a ``Trainer`` on the card resumed through
    ``FaultTolerantLoop`` after an injected failure, to the params of an
    uninterrupted run."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core.exchange import ExchangeConfig
    from repro_torch.core.seq_group import spawn
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.utils.tree import tree_leaves
    cfg, params = _small_llama()[:2]
    t0 = time.perf_counter()
    local = {dev: _train_ref_run(params, cfg, ExchangeConfig(), dev)
             for dev in ("cuda", "cpu")}
    print(f"[train-reference] reduced f32 {ARCH} ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, dh "
          f"{cfg.hd}), B {SMALL_LM_B} N {TRAIN_REF_N}, one process local, "
          f"card vs CPU: " + _check_ref("local", local["cuda"], local["cpu"]),
          flush=True)
    ranks = spawn(_train_ref_rank, LM_P, timeout=RANK_TIMEOUT_S)
    for mode in ("voltage", "prism"):
        for rank, r in enumerate(ranks):
            text = _check_ref(f"{mode} rank {rank}", r[f"{mode}/cuda"],
                              r[f"{mode}/cpu"])
            for a, b in zip(r[f"{mode}/cuda"]["params"],
                            ranks[0][f"{mode}/cuda"]["params"]):
                if not np.array_equal(a, b):
                    raise AssertionError(f"{mode}: the replicas differ")
            sm, pa = r[f"{mode}/cuda"]["launches"]
            if mode == "prism" and not (sm > 0 and pa > 0):
                raise AssertionError("prism training launched no kernel")
            print(f"[train-reference] {LM_P} ranks on the card vs {LM_P} "
                  f"CPU ranks, {text}; segment_means {sm}, prism_attention "
                  f"{pa} launches; replicas bit-identical", flush=True)
    runs = []
    for fail in (None, {3: "host0"}):
        with tempfile.TemporaryDirectory() as d:
            tr = Trainer(cfg, ExchangeConfig(), TrainerConfig(
                steps=6, ckpt_every=2, batch_size=SMALL_LM_B,
                seq_len=TRAIN_REF_N, ckpt_dir=d), OptConfig(**TRAIN_OPT),
                device="cuda", params=_on(params, "cuda"))
            tr.run(fail_at=fail)
            runs.append(tr)
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves((runs[0].params, runs[0].opt_state)),
        tree_leaves((runs[1].params, runs[1].opt_state))))
    kinds = [e.kind for e in runs[1].loop.events]
    if not (same and kinds == ["node_down", "restart"]):
        raise AssertionError(f"resumed Trainer: events {kinds}, params "
                             f"{'equal' if same else 'differ'}")
    print(f"[train-reference] Trainer on the card, 6 steps, checkpoint every"
          f" 2, failure injected at step 3: restored step "
          f"{runs[1].loop.events[1].step}, ends on the uninterrupted run's "
          f"params and moments bit for bit; {time.perf_counter() - t0:.1f} s"
          f" with rank start-up [{card}]", flush=True)


# --- [train]: llama3.2-1b at full width and depth, one process -------------

def _profile_step(fn) -> tuple:
    """(result, wall ms, kernel-busy ms) of one ``fn()`` under
    torch.profiler (device activity only: a train step's host ops are
    thousands of events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e3
    return out, wall, busy


def _forward_held(cfg, params, batch, xcfg) -> tuple:
    """One forward and backward of the train step's loss (as
    ``_grads_of`` runs them) → (GB allocated between the end of the
    forward and its backward: what the backward keeps alive, the logits'
    f32 log-sum-exp pieces included; GB of the tensors autograd saved
    outside rematerialised regions, parameters not counted: without
    rematerialisation every layer's activations; the peak GB of the
    forward and backward alone)."""
    import torch
    from repro_torch.train.train_step import loss_fn
    from repro_torch.utils.tree import tree_leaves, tree_unflatten_like
    leaves = tree_leaves(params)
    owned = {t.untyped_storage().data_ptr() for t in leaves}
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in owned:
            saved[st.data_ptr()] = st.nbytes()
        return t
    live = [t.detach().requires_grad_(t.is_floating_point()) for t in leaves]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = loss_fn(tree_unflatten_like(params, live), batch, cfg,
                          xcfg)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - m0
    torch.autograd.grad(loss, [t for t in live if t.requires_grad])
    torch.cuda.synchronize()
    return (held / 1e9, sum(saved.values()) / 1e9,
            torch.cuda.max_memory_allocated() / 1e9)


def train_dry_run() -> dict:
    """[train]'s step traced on the meta device in this process
    (``launch.dryrun.trace_step``: one ``build_train_step`` step of
    llama3.2-1b, bf16 params and f32 moments, B 4 N 512, ``local``), each
    layer rematerialised and then without → mode → (peak GB: the step's
    arguments and its live bytes at their most; argument GB; trace s).
    Counted, not measured."""
    from repro_torch.configs import get_config
    from repro_torch.core.exchange import ExchangeMode
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.models import remat
    import contextlib
    out = {}
    for mode, ctx in (("remat", contextlib.nullcontext),
                      ("no remat", remat.disabled)):
        with ctx():
            got = trace_step(get_config(ARCH), "train", None,
                             mode=ExchangeMode.LOCAL, B=TRAIN_B, N=TRAIN_N)
        out[mode] = (got["peak_bytes"] / 1e9, got["argument_bytes"] / 1e9,
                     got["trace_s"])
    return out


def phase_train(card: str) -> dict:
    """``[train]``: llama3.2-1b at full width and depth, bf16 params and
    f32 moments, B 4 N 512 under ``local``, TRAIN_STEPS AdamW steps through
    ``Trainer`` (no checkpoint: the state is ~12 GB; its directory is a
    fresh temporary one, so no earlier run's checkpoint is restored), with
    each layer rematerialised (the default) and then without
    (``remat.disabled``) → per mode each step's ms and loss, tokens/s,
    the last step's device idle share (torch.profiler), peak memory, and
    one more forward's held memory, saved-tensor bytes and the peak of the
    forward and backward alone."""
    import contextlib
    import gc
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.exchange import ExchangeConfig
    from repro_torch.models import remat
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.utils.tree import param_count
    cfg = get_config(ARCH)
    out = {}
    for mode in ("remat", "no remat"):
        gc.collect()                   # the last mode's trainer: a cycle
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ckpt_dir = tempfile.TemporaryDirectory()
        tr = Trainer(cfg, ExchangeConfig(), TrainerConfig(
            steps=TRAIN_STEPS, ckpt_every=10 ** 9, batch_size=TRAIN_B,
            seq_len=TRAIN_N, ckpt_dir=ckpt_dir.name), device="cuda")
        inner, ms, prof = tr.step_fn, [], {}

        def timed(params, opt, batch):
            if len(ms) == TRAIN_STEPS - 1:
                res, wall, busy = _profile_step(lambda: inner(params, opt,
                                                              batch))
                prof.update(wall=wall, busy=busy)
                ms.append(wall)
                return res
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = inner(params, opt, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            return res
        tr.step_fn = timed
        off = remat.disabled() if mode == "no remat" else \
            contextlib.nullcontext()
        with ckpt_dir, off:
            tr.run()
            peak = torch.cuda.max_memory_allocated() / 1e9
            held, saved, fb_peak = _forward_held(
                cfg, tr.params, tr.batch_for_step(0), ExchangeConfig())
        losses = [m["loss"] for m in tr.metrics_log]
        if not (len(losses) == TRAIN_STEPS and np.isfinite(losses).all()):
            raise AssertionError(f"[train] {mode}: losses {losses}")
        steady = float(np.median(ms[1:-1]))
        print(f"[train] {ARCH} full width and depth ({cfg.n_layers} layers, "
              f"d {cfg.d_model}, vocab {cfg.vocab_size}, "
              f"{param_count(tr.params) / 1e9:.3f} B params bf16, AdamW "
              f"moments f32), B {TRAIN_B} N {TRAIN_N}, local, {mode}, "
              f"{TRAIN_STEPS} steps through Trainer: step ms "
              + ", ".join(f"{t:.1f}" for t in ms)
              + f" (the last under torch.profiler); steady {steady:.1f} ms ="
              f" {TRAIN_B * TRAIN_N / steady * 1e3:.0f} tokens/s; last step "
              f"kernels busy {prof['busy']:.1f} of {prof['wall']:.1f} ms "
              f"(device idle {1 - prof['busy'] / prof['wall']:.1%}); peak "
              f"{peak:.2f} GB (a forward and backward alone: "
              f"{fb_peak:.2f} GB); a forward holds {held:.2f} GB for its "
              f"backward, autograd saving {saved:.2f} GB outside "
              f"rematerialised regions; loss "
              + " → ".join(f"{x:.4f}" for x in losses) + f" [{card}]",
              flush=True)
        out[mode] = dict(peak=peak, steady=steady, held=held, saved=saved,
                         fb_peak=fb_peak, losses=losses)
        del tr, inner, timed
    on, no = out["remat"], out["no remat"]
    dry = train_dry_run()
    for mode, (peak, args, secs) in dry.items():
        print(f"[train] dry run ({mode}, launch.dryrun on the meta device in "
              f"this process, {secs:.1f} s; counted, not measured): one step"
              f"'s peak {peak:.2f} GB, of which its arguments (params and "
              f"moments) {args:.2f} GB; with the Trainer's first state still "
              f"held beside the loop's (Trainer.run) {peak + args:.2f} GB; "
              f"measured {out[mode]['peak']:.2f} GB [{card}]", flush=True)
    print(f"[train] rematerialised: peak {on['peak']:.2f} GB (without "
          f"{no['peak']:.2f} GB; earlier runs, PERF.md §5: 39.92 / 40.99 "
          f"GB), steady step {on['steady']:.1f} ms (without "
          f"{no['steady']:.1f} ms; earlier runs 209.3 / 198.5 ms), held "
          f"for the backward {on['held']:.2f} GB "
          f"(without {no['held']:.2f} GB), forward + backward peak "
          f"{on['fb_peak']:.2f} GB (without {no['fb_peak']:.2f} GB) "
          f"[{card}]", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --- [train-seq]: llama3.2-1b at full width on 2 ranks ---------------------

def train_seq_bytes(cfg, mode: str, P: int, n_params: int) -> dict:
    """Bytes one rank receives in a train step, from the shapes: the
    forward's K/V (``voltage``) or means (``prism``) gather a layer in
    bf16, the backward's reduce-scattered cotangent of each in f32 with
    the summed parameter gradients (f32) as ``grad``, and the metrics'
    sum (3 f32) as ``meta``."""
    Np = LM_N // P
    rows = Np if mode == "voltage" else LM_L
    kv = 2 * LM_B * rows * cfg.n_kv_heads * cfg.hd
    return dict(payload=cfg.n_layers * (P - 1) * kv * 2,
                grad=cfg.n_layers * (P - 1) * kv * 4
                + (P - 1) * 4 * n_params,
                meta=(P - 1) * 3 * 4)


def _warm_remat() -> float:
    """Seconds of this process's first rematerialised call, made on a
    scalar before anything is timed: torch's checkpoint imports
    ``torch._dynamo`` on its first call in a process."""
    import torch
    from repro_torch.models import remat
    t0 = time.perf_counter()
    x = torch.ones(1, device="cuda", requires_grad=True)
    remat.region(torch.sin, x).sum().backward()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _remat_mode(remat_on: bool):
    """A context with rematerialisation on (the default) or off."""
    import contextlib
    from repro_torch.models import remat
    return contextlib.nullcontext() if remat_on else remat.disabled()


def _digest(tree) -> str:
    import hashlib
    import torch
    from repro_torch.utils.tree import tree_leaves
    h = hashlib.sha1()
    for t in tree_leaves(tree):
        h.update(t.contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def _train_seq_rank(rank, world, remat_on=True):
    """One rank of llama3.2-1b cut to TRAIN_SEQ_LAYERS layers at full width
    on the shared card: TRAIN_SEQ_STEPS steps under ``voltage`` and
    ``prism(L=16)`` from the same weights → per step ms, staged ms, bytes
    by kind, kernel launches and loss, and the digest of the final params."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.exchange import ExchangeConfig, ExchangeMode
    from repro_torch.core.seq_group import get_seq_group
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.kernels.prism_attention import prism_attention
    from repro_torch.kernels.segment_means import segment_means
    from repro_torch.models import registry
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import build_train_step
    from repro_torch.utils.tree import param_count
    group = get_seq_group("seq")
    warm = _warm_remat() if remat_on else 0.0
    cfg = dataclasses.replace(get_config(ARCH), n_layers=TRAIN_SEQ_LAYERS)
    params0 = registry.init_params(cfg, seed=0, device="cuda")
    ds = SyntheticLMDataset(cfg.vocab_size, LM_N, LM_B)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in ds.sample(
        np.random.RandomState(1000 + s)).items()}
        for s in range(TRAIN_SEQ_STEPS)]
    out = dict(n_params=param_count(params0), steps={}, warm_s=warm)
    for mode in ("voltage", "prism"):
        xcfg = ExchangeConfig(ExchangeMode(mode), seq_axis="seq",
                              seq_shards=world, L=LM_L)
        step = build_train_step(cfg, xcfg)
        p, o = params0, adamw_init(params0)
        rows = []
        for b in batches:
            group.reset_stats()
            before = (segment_means.launches, prism_attention.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _remat_mode(remat_on):
                p, o, m = step(p, o, b)
            torch.cuda.synchronize()
            st = group.stats
            rows.append(dict(
                ms=(time.perf_counter() - t0) * 1e3,
                staged_ms=st.seconds * 1e3, calls=st.calls,
                payload=st.payload_bytes, meta=st.meta_bytes,
                grad=st.grad_bytes, loss=float(m["loss"]),
                launches=(segment_means.launches - before[0],
                          prism_attention.launches - before[1])))
        out["steps"][mode] = dict(rows=rows, digest=_digest(p))
        del p, o
        torch.cuda.empty_cache()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def phase_train_seq(card: str, remat_on: bool = True) -> dict:
    """``[train-seq]``: llama3.2-1b cut to 4 of 16 layers at full width on 2
    ranks sharing the card, each layer rematerialised (``remat_on``, the
    default) or not → segment-means and PRISM-attention launches of the
    ``prism`` train steps, summed over the ranks (launch.train's reduced
    llama at head width 16 runs in ``[mesh]``)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.seq_group import spawn
    runs = 2 if remat_on else 1        # the forward and its recompute
    label = "rematerialised" if remat_on else "without rematerialisation"
    t0 = time.perf_counter()
    ranks = spawn(_train_seq_rank, LM_P, remat_on, timeout=RANK_TIMEOUT_S)
    cfg = dataclasses.replace(get_config(ARCH), n_layers=TRAIN_SEQ_LAYERS)
    n_params = ranks[0]["n_params"]
    print(f"[train-seq] {ARCH} cut to {TRAIN_SEQ_LAYERS} of 16 layers at full"
          f" width (d {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{n_params / 1e9:.3f} B params bf16, f32 moments) on {LM_P} ranks "
          f"sharing the card, B {LM_B} N {LM_N}, {TRAIN_SEQ_STEPS} steps "
          f"each, {label}; {time.perf_counter() - t0:.1f} s with rank "
          f"start-up (the first rematerialised call "
          f"{max(r['warm_s'] for r in ranks):.1f} s of it: torch imports "
          f"torch._dynamo once a process); peak "
          f"{max(r['peak_gb'] for r in ranks):.2f} GB a rank (earlier "
          f"runs without rematerialisation, PERF.md §5: 15.55 GB; steady "
          f"steps voltage 2474.1 / 1907.0 ms, prism 2025.1 / 1999.0 ms) "
          f"[{card}]",
          flush=True)
    launches = {"segment_means": 0, "prism_attention": 0}
    for mode in ("voltage", "prism"):
        want = train_seq_bytes(cfg, mode, LM_P, n_params)
        digests = {r["steps"][mode]["digest"] for r in ranks}
        if len(digests) != 1:
            raise AssertionError(f"[train-seq] {mode}: the replicas differ")
        for rank, r in enumerate(ranks):
            rows = r["steps"][mode]["rows"]
            for row in rows:
                for kind, n in want.items():
                    if row[kind] != n:
                        raise AssertionError(
                            f"[train-seq] {mode} rank {rank}: {kind} bytes "
                            f"{row[kind]} != {n} from the shapes")
                sm, pa = row["launches"]
                want_n = runs * cfg.n_layers
                if mode == "prism" and (sm, pa) != (want_n, want_n):
                    raise AssertionError(f"[train-seq] prism: launches "
                                         f"{(sm, pa)} a step, want {runs} of "
                                         f"each a layer")
                if mode == "prism":
                    launches["segment_means"] += sm
                    launches["prism_attention"] += pa
            losses = [x["loss"] for x in rows]
            if not all(x == x and abs(x) < 1e9 for x in losses):
                raise AssertionError(f"[train-seq] {mode}: loss {losses}")
            steady = rows[1:] or rows
            ms = statistics.median(x["ms"] for x in steady)
            staged = statistics.median(x["staged_ms"] for x in steady)
            print(f"[train-seq] {mode}{'' if mode == 'voltage' else f'(L={LM_L})'}"
                  f" rank {rank}: step ms "
                  + ", ".join(f"{x['ms']:.1f}" for x in rows)
                  + f"; steady {ms:.1f} ms, staged {staged:.1f} ms "
                  f"({staged / ms:.1%}) in {steady[0]['calls']} calls; "
                  f"received payload {want['payload'] / 1e6:.3f} MB, meta "
                  f"{want['meta']} B, grad {want['grad'] / 1e6:.1f} MB a step"
                  f" (= the shapes); segment_means {rows[0]['launches'][0]}, "
                  f"prism_attention {rows[0]['launches'][1]} launches a step;"
                  f" loss " + " → ".join(f"{x:.4f}" for x in losses)
                  + f"; replicas bit-identical [{card}]", flush=True)
    return launches


# --- [train-reference], every family: small f32 configs, card vs CPU ranks -

# label → (arch, mode, exchange options, ranks): every family's partitioned
# training and every collective's backward (the halo's shift on 4 ranks,
# the ring, the packed codec gather, the routing call, MLA's latent, the
# cross-attention exchange, the recurrent hand-off, the logits broadcast)
TRAIN_FAMILIES = {
    "gemma2 prism, the halo": (GEMMA, "prism", {}, 4),
    "llama voltage, the ring": (ARCH, "voltage", dict(overlap_chunks=2), 2),
    "llama prism+int8": (ARCH, "prism", dict(codec="int8"), 2),
    "llama prism+int4": (ARCH, "prism", dict(codec="int4"), 2),
    "llama prism+topk": (ARCH, "prism", dict(codec="topk", codec_param=8),
                         2),
    "deepseek-moe prism, the routing call": (MOE, "prism", {}, 2),
    "deepseek-v2 prism, MLA's latent": (MLA_ARCH, "prism", {}, 2),
    "whisper prism, the encoder and cross": (WHISPER, "prism", {}, 2),
    "vision prism, the gated cross": (VISION, "prism", {}, 2),
    "hymba prism, the hand-off": (HYMBA, "prism", {}, 2),
    "xlstm voltage, the hand-off": (XLSTM, "voltage", {}, 2),
    "vit prism, the logits broadcast": (VIT, "prism", {}, 2),
    "llama prism, last_only's broadcast": (ARCH, "prism", {}, 2),
}
TRAIN_FAMILY_B, TRAIN_FAMILY_N, TRAIN_FAMILY_M = 2, 32, 13


def _family_reduced(arch) -> dict:
    """The small f32 config's overrides of ``arch``: the reference phases'
    (heads of 64, MLA at deepseek-v2's widths), which the kernels take."""
    from repro_torch.configs.base import MLACfg
    if arch in (MOE, MLA_ARCH):
        over = dict(dtype="float32", n_heads=8, n_kv_heads=8, d_model=256)
        if arch == MOE:
            return dict(over, head_dim=64)
        return dict(over, mla=MLACfg(kv_lora_rank=64, q_lora_rank=96,
                                     qk_nope_dim=128, qk_rope_dim=64,
                                     v_head_dim=128))
    if arch in (WHISPER, VISION):
        return dict(dtype="float32", head_dim=64, n_heads=8, d_model=256,
                    n_kv_heads=8 if arch == WHISPER else 2)
    return {GEMMA: SMALL_GEMMA, ARCH: SMALL_LLAMA, VIT: SMALL_VIT,
            HYMBA: SMALL_SSM["hymba"][1], XLSTM: SMALL_SSM["xlstm"][1]}[arch]


def _family_grad(label, world, device) -> dict:
    """Case ``label`` of TRAIN_FAMILIES on this rank: the small f32
    config from seed 0 (vlm gates at XATTN_GATE), its loss share and
    gradient summed over the ranks → numpy, with the kernels' launches.
    A broadcast case's loss reads logits every rank receives by
    ``SeqGroup.broadcast`` (the ViT's class cross-entropy, an LM's
    ``last_only`` logsumexp), 1/P of it a rank."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.exchange import (ExchangeConfig, ExchangeMode,
                                           seq_group_for)
    from repro_torch.kernels.prism_attention import prism_attention
    from repro_torch.kernels.segment_means import segment_means
    from repro_torch.models import registry
    from repro_torch.models import transformer as tfm
    from repro_torch.models.vit import forward_vit
    from repro_torch.train.train_step import _grads_of
    from repro_torch.utils.tree import tree_leaves, tree_unflatten_like
    arch, mode, kw, _ = TRAIN_FAMILIES[label]
    cfg = get_config(arch).reduced(**_family_reduced(arch))
    params = registry.init_params(cfg, seed=0, device="cpu")
    _open_gates(params)
    Np = TRAIN_FAMILY_N // world
    xcfg = ExchangeConfig(ExchangeMode(mode), seq_axis="seq",
                          seq_shards=world, **kw,
                          L=(Np // 4 if mode == "prism" else 0))
    group = seq_group_for(xcfg)
    g = torch.Generator().manual_seed(5)
    B = TRAIN_FAMILY_B
    if arch == VIT:
        batch = {"images": torch.randn(B, 224, 224, 3, generator=g),
                 "labels": torch.randint(0, cfg.vocab_size, (B,),
                                         generator=g)}
    else:
        batch = {k: torch.randint(0, cfg.vocab_size, (B, TRAIN_FAMILY_N),
                                  generator=g) for k in ("tokens", "labels")}
    if cfg.family in ("audio", "vlm"):
        batch[_memory_name(cfg)] = torch.randn(B, TRAIN_FAMILY_M, cfg.d_model,
                                               generator=g)
    p, batch = _on(params, device), _on(batch, device)
    before = (segment_means.launches, prism_attention.launches)
    if "broadcast" in label:
        leaves = tree_leaves(p)
        live = [t.detach().requires_grad_() for t in leaves]
        tree = tree_unflatten_like(p, live)
        if arch == VIT:
            logits = forward_vit(tree, batch["images"], cfg, xcfg)
            loss = torch.nn.functional.cross_entropy(
                logits, batch["labels"].long())
        else:
            logits, _ = tfm.forward_lm(tree, {"tokens": batch["tokens"]},
                                       cfg, xcfg, last_only=True)
            loss = torch.logsumexp(logits, dim=-1).mean()
        loss = loss / world
        grads = [torch.zeros_like(t) if d is None else d for t, d in zip(
            leaves, torch.autograd.grad(loss, live, allow_unused=True))]
        loss = loss.detach()
    else:
        loss, _, grads = _grads_of(p, batch, cfg, xcfg)
    launches = (segment_means.launches - before[0],
                prism_attention.launches - before[1])
    grads = group.all_reduce(grads, kind="grad")
    loss = group.all_reduce([loss[None]], kind="meta")[0][0]
    return dict(loss=float(loss), launches=launches,
                grads=[t.float().cpu().numpy() for t in grads])


def _train_family_rank(rank, world, labels):
    """Each case of ``labels`` on the card, then on the CPU."""
    _exact_fp32()
    return {label: {dev: _family_grad(label, world, dev)
                    for dev in ("cuda", "cpu")} for label in labels}


def phase_train_families(card: str) -> None:
    """``[train-reference]``, every family: each case of TRAIN_FAMILIES on
    card ranks against the same ranks on the CPU (the plain versions):
    gradient ≤ 1e-4 of each leaf's largest value, loss ≤ 1e-5 relative,
    the ranks' summed gradients bit-identical on the card; a ``prism``
    case with attention and no codec launches both kernels."""
    import numpy as np
    from repro_torch.core.seq_group import spawn
    t0 = time.perf_counter()
    runs = {}
    worlds = sorted({c[3] for c in TRAIN_FAMILIES.values()})
    cases = [[lb for lb, c in TRAIN_FAMILIES.items() if c[3] == world]
             for world in worlds]
    with concurrent.futures.ThreadPoolExecutor(len(worlds)) as pool:
        spawned = list(pool.map(            # every world at once: the
            lambda wl: spawn(_train_family_rank, *wl,   # start-ups overlap
                             timeout=RANK_TIMEOUT_S), zip(worlds, cases)))
    for labels, ranks in zip(cases, spawned):
        for lb in labels:
            runs[lb] = [r[lb] for r in ranks]
    for label, (arch, mode, kw, world) in TRAIN_FAMILIES.items():
        ranks = runs[label]
        g_err = max(_leaf_errs(r["cuda"]["grads"], r["cpu"]["grads"])
                    for r in ranks)
        l_err = max(abs(r["cuda"]["loss"] - r["cpu"]["loss"])
                    / abs(r["cpu"]["loss"]) for r in ranks)
        if not (g_err <= 1e-4 and l_err <= 1e-5):
            raise AssertionError(f"[train-reference] {label}: gradient off "
                                 f"by {g_err:.3e} (tol 1e-4), loss by "
                                 f"{l_err:.3e} (tol 1e-5)")
        for r in ranks[1:]:
            for a, b in zip(r["cuda"]["grads"], ranks[0]["cuda"]["grads"]):
                if not np.array_equal(a, b):
                    raise AssertionError(f"[train-reference] {label}: the "
                                         f"ranks' summed gradients differ")
        sm = sum(r["cuda"]["launches"][0] for r in ranks)
        pa = sum(r["cuda"]["launches"][1] for r in ranks)
        kernels = mode == "prism" and not kw.get("codec")
        if kernels and not (sm > 0 and pa > 0):
            raise AssertionError(f"[train-reference] {label}: launched "
                                 f"segment_means {sm}, prism_attention {pa}")
        print(f"[train-reference] {label} ({arch} reduced f32, B "
              f"{TRAIN_FAMILY_B} N {TRAIN_FAMILY_N}, {mode}"
              + "".join(f" {k}={v}" for k, v in kw.items())
              + f", {world} card ranks vs {world} CPU ranks): gradient "
              f"{g_err:.2e} of the largest (tol 1e-4), loss {l_err:.2e} "
              f"(tol 1e-5); summed gradients bit-identical over the ranks; "
              f"segment_means {sm}, prism_attention {pa} launches",
              flush=True)
    print(f"[train-reference] {len(TRAIN_FAMILIES)} family cases in "
          f"{time.perf_counter() - t0:.1f} s with rank start-up [{card}]",
          flush=True)


# --- [train-seq-families]: gemma2-27b and hymba-1.5b at full width ---------

GEMMA_TRAIN_LAYERS, GEMMA_TRAIN_B = 2, 1      # one local/global pair, B 1,
                                              # N GEMMA_N on GEMMA_P ranks
GEMMA_TRAIN_VOCAB = 128000    # of 256000: at the full vocabulary each of
                              # the 4 ranks' f32 logits and their backward
                              # take ~10 GB, and the 4 ranks did not fit 80 GB
HYMBA_TRAIN_LAYERS, HYMBA_TRAIN_STEPS = 4, 2  # 2 ranks, B LM_B, N LM_N
SUM_PIECE = 1 << 26           # elements an all_reduce call of [train-seq-
                              # families]' gradient sum: 256 MB of f32


def gemma_train_bytes(cfg, rank: int, n_params: int) -> dict:
    """Bytes rank ``rank`` receives in [train-seq-families]' gemma2 step,
    from the shapes: the windowed layer's halo (a shift of K and V
    ``[2, B, Np, Hk, dh]`` bf16 from each of the ``n_halo`` ranks before
    it that exist) and its cotangents back (bf16, from each of the
    ``n_halo`` ranks after it), the global layer's means ``[2, B, L, Hk,
    dh]`` bf16 gathered and their f32 cotangents reduce-scattered, the
    loss's sum (one f32) and the gradient sum ((P − 1) × 4 × the params)."""
    P, Np = GEMMA_P, GEMMA_N // GEMMA_P
    n_halo = -(-cfg.window // Np)
    blk = 2 * GEMMA_TRAIN_B * Np * cfg.n_kv_heads * cfg.hd
    means = 2 * GEMMA_TRAIN_B * GEMMA_L * cfg.n_kv_heads * cfg.hd
    fwd = sum(1 for s in range(1, n_halo + 1) if rank - s >= 0)
    bwd = sum(1 for s in range(1, n_halo + 1) if rank + s < P)
    return dict(payload=fwd * blk * 2 + (P - 1) * means * 2,
                grad=bwd * blk * 2 + (P - 1) * means * 4
                + (P - 1) * 4 * n_params,
                meta=(P - 1) * 4, halo_calls=n_halo, state=0)


def _sum_in_pieces(group, grads) -> tuple:
    """The gradient sum of a step through ``SeqGroup.all_reduce``, in
    pieces of at most SUM_PIECE elements, each dropped once summed (the f32
    sums of 2.3 B parameters would not fit beside 4 ranks' models) →
    (ms, staged ms, the f64 sum of squares of the summed gradient)."""
    import torch
    t0, s0 = time.perf_counter(), group.stats.seconds
    sq = torch.zeros((), dtype=torch.float64, device=grads[0].device)
    for gr in grads:
        for piece in gr.reshape(-1).split(SUM_PIECE):
            sq += group.all_reduce([piece], kind="grad")[0].double(
                ).square().sum()
    sq = float(sq)
    return ((time.perf_counter() - t0) * 1e3,
            (group.stats.seconds - s0) * 1e3, sq)


def _gemma_train_rank(rank, world, remat_on=True):
    """One rank of gemma2-27b's local/global pair at full width: one
    forward + backward (``_grads_of``, the train step's) of B 1 over
    GEMMA_N tokens under ``prism(L=16)``, each layer rematerialised
    (``remat_on``) or not, then the gradient sum → its ms, staged ms, bytes
    by kind, halo calls, launches and peak memory."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.exchange import ExchangeConfig, ExchangeMode
    from repro_torch.core.seq_group import get_seq_group
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.kernels.prism_attention import prism_attention
    from repro_torch.kernels.segment_means import segment_means
    from repro_torch.models import registry
    from repro_torch.train.train_step import _grads_of
    from repro_torch.utils.tree import param_count
    group = get_seq_group("seq")
    warm = _warm_remat() if remat_on else 0.0
    cfg = dataclasses.replace(get_config(GEMMA), n_layers=GEMMA_TRAIN_LAYERS,
                              vocab_size=GEMMA_TRAIN_VOCAB)
    params = registry.init_params(cfg, seed=0, device="cuda")
    ds = SyntheticLMDataset(cfg.vocab_size, GEMMA_N, GEMMA_TRAIN_B)
    batch = {k: torch.from_numpy(v).cuda() for k, v in ds.sample(
        np.random.RandomState(1000)).items()}
    xcfg = ExchangeConfig(ExchangeMode.PRISM, seq_axis="seq",
                          seq_shards=world, L=GEMMA_L)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    group.reset_stats()
    before = (segment_means.launches, prism_attention.launches)
    t0 = time.perf_counter()
    with _remat_mode(remat_on):
        loss, _, grads = _grads_of(params, batch, cfg, xcfg)
    torch.cuda.synchronize()
    fb_ms = (time.perf_counter() - t0) * 1e3
    st = group.stats
    fb = dict(staged_ms=st.seconds * 1e3, fb_calls=st.calls,
              halo_calls=st.halo_calls,
              launches=(segment_means.launches - before[0],
                        prism_attention.launches - before[1]))
    peak_fb = torch.cuda.max_memory_allocated() / 1e9
    loss = float(group.all_reduce([loss[None]], kind="meta")[0][0])
    sum_ms, sum_staged, sq = _sum_in_pieces(group, grads)
    st = group.stats
    return dict(fb_ms=fb_ms, sum_ms=sum_ms, sum_staged_ms=sum_staged,
                loss=loss, sq=sq, n_params=param_count(params),
                payload=st.payload_bytes, meta=st.meta_bytes,
                grad=st.grad_bytes, state=st.state_bytes,
                calls=st.calls, peak_fb_gb=peak_fb, warm_s=warm,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9, **fb)


def hymba_train_bytes(cfg, mode: str, rank: int, n_params: int) -> dict:
    """Bytes rank ``rank`` receives in a [train-seq-families] hymba step,
    from the shapes: each layer's K/V (``voltage``) or means (``prism``)
    gather in bf16 and its f32 cotangent reduce-scattered; rank 1 the
    Mamba state a layer (h ``[B, di, S]`` f32 and the conv tail ``[B,
    W − 1, di]`` bf16), rank 0 its cotangent back (f32, the same leaves);
    the metrics' sum (3 f32); the gradient sum in f32."""
    P, Np = LM_P, LM_N // LM_P
    rows = Np if mode == "voltage" else LM_L
    kv = 2 * LM_B * rows * cfg.n_kv_heads * cfg.hd
    s = cfg.ssm
    di = s.expand * cfg.d_model
    h, conv = LM_B * di * s.state_size, LM_B * (s.conv_width - 1) * di
    n = cfg.n_layers
    return dict(payload=n * (P - 1) * kv * 2,
                state=n * (h * 4 + conv * 2) if rank > 0 else 0,
                grad=n * (P - 1) * kv * 4
                + (n * (h + conv) * 4 if rank < P - 1 else 0)
                + (P - 1) * 4 * n_params,
                meta=(P - 1) * 3 * 4, halo_calls=0)


def _hymba_train_rank(rank, world, remat_on=True):
    """One rank of hymba-1.5b cut to HYMBA_TRAIN_LAYERS layers at full
    width: HYMBA_TRAIN_STEPS train steps (AdamW) under ``voltage`` and
    ``prism(L=16)`` from the same weights, each layer rematerialised
    (``remat_on``) or not → per step ms, staged ms, bytes by kind, state
    calls, launches, loss, and the digest of the params."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.exchange import ExchangeConfig, ExchangeMode
    from repro_torch.core.seq_group import get_seq_group
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.kernels.prism_attention import prism_attention
    from repro_torch.kernels.segment_means import segment_means
    from repro_torch.models import registry
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import build_train_step
    from repro_torch.utils.tree import param_count
    group = get_seq_group("seq")
    warm = _warm_remat() if remat_on else 0.0
    cfg = dataclasses.replace(get_config(HYMBA), n_layers=HYMBA_TRAIN_LAYERS)
    params0 = registry.init_params(cfg, seed=0, device="cuda")
    ds = SyntheticLMDataset(cfg.vocab_size, LM_N, LM_B)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in ds.sample(
        np.random.RandomState(1000 + i)).items()}
        for i in range(HYMBA_TRAIN_STEPS)]
    out = dict(n_params=param_count(params0), steps={}, warm_s=warm)
    torch.cuda.reset_peak_memory_stats()
    for mode in ("voltage", "prism"):
        xcfg = ExchangeConfig(ExchangeMode(mode), seq_axis="seq",
                              seq_shards=world, L=LM_L)
        step = build_train_step(cfg, xcfg)
        p, o, rows = params0, adamw_init(params0), []
        for b in batches:
            group.reset_stats()
            before = (segment_means.launches, prism_attention.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _remat_mode(remat_on):
                p, o, m = step(p, o, b)
            torch.cuda.synchronize()
            st = group.stats
            rows.append(dict(
                ms=(time.perf_counter() - t0) * 1e3,
                staged_ms=st.seconds * 1e3, calls=st.calls,
                payload=st.payload_bytes, meta=st.meta_bytes,
                state=st.state_bytes, grad=st.grad_bytes,
                halo_calls=st.halo_calls, state_calls=st.state_calls,
                loss=float(m["loss"]),
                launches=(segment_means.launches - before[0],
                          prism_attention.launches - before[1])))
        out["steps"][mode] = dict(rows=rows, digest=_digest(p))
        del p, o
        torch.cuda.empty_cache()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _check_bytes(tag: str, got: dict, want: dict) -> None:
    for kind, n in want.items():
        if got[kind] != n:
            raise AssertionError(f"{tag}: {kind} {got[kind]} != {n} from "
                                 f"the shapes")


def phase_train_seq_families(card: str, remat_on: bool = True) -> dict:
    """``[train-seq-families]``: gemma2-27b's local/global pair at full
    width (the vocabulary cut to GEMMA_TRAIN_VOCAB) on GEMMA_P ranks
    sharing the card (B 1, N GEMMA_N: parts of 2048, so the windowed
    layer's halo runs; one forward + backward + gradient sum, no
    optimizer: 4 ranks' f32 moments would not fit), then
    hymba-1.5b cut to HYMBA_TRAIN_LAYERS layers on LM_P ranks (B LM_B, N
    LM_N, HYMBA_TRAIN_STEPS steps under each plan), each layer
    rematerialised (``remat_on``, the default) or not → the kernels'
    launches in both, summed over the ranks."""
    import dataclasses
    import gc
    import os
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.seq_group import spawn
    # this process's cached blocks from the phases before go back to the
    # card: the 4 ranks need all but ~10 GB of it
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train-seq-families] this process holds "
          f"{torch.cuda.memory_reserved() / 1e9:.2f} GB of the card before "
          f"the ranks start", flush=True)
    launches = dict.fromkeys(
        ("segment_means_gemma", "prism_attention_gemma",
         "segment_means_hymba", *[f"prism_attention_hymba_{p}"
                                  for p in range(LM_P)]), 0)
    t0 = time.perf_counter()
    # the ranks' allocators grow segments in place (4 ranks share 80 GB)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    runs = 2 if remat_on else 1        # the forward and its recompute
    label = "rematerialised" if remat_on else "without rematerialisation"
    ranks = spawn(_gemma_train_rank, GEMMA_P, remat_on,
                  timeout=RANK_TIMEOUT_S)
    cfg = dataclasses.replace(get_config(GEMMA), n_layers=GEMMA_TRAIN_LAYERS,
                              vocab_size=GEMMA_TRAIN_VOCAB)
    n_params = ranks[0]["n_params"]
    if len({(r["sq"], r["loss"]) for r in ranks}) != 1:
        raise AssertionError("[train-seq-families] gemma2: the ranks' summed "
                             "gradients or losses differ")
    for rank, r in enumerate(ranks):
        want = gemma_train_bytes(cfg, rank, n_params)
        _check_bytes(f"[train-seq-families] gemma2 rank {rank}", r, want)
        sm, pa = r["launches"]
        want_n = runs * (cfg.n_layers // 2)
        if (sm, pa) != (want_n, want_n):
            raise AssertionError(f"[train-seq-families] gemma2: launches "
                                 f"{(sm, pa)}, want {runs} of each a global "
                                 f"layer")
        launches["segment_means_gemma"] += sm
        launches["prism_attention_gemma"] += pa
        if not (r["loss"] == r["loss"] and r["sq"] > 0):
            raise AssertionError(f"[train-seq-families] gemma2: loss "
                                 f"{r['loss']}, |g|² {r['sq']}")
        print(f"[train-seq-families] {GEMMA} {GEMMA_TRAIN_LAYERS} layers "
              f"(one windowed, one global) at full width (d {cfg.d_model}; "
              f"vocab cut to {cfg.vocab_size}; {n_params / 1e9:.3f} B "
              f"params bf16) "
              f"rank {rank} of {GEMMA_P}, B {GEMMA_TRAIN_B} N {GEMMA_N}, "
              f"prism(L={GEMMA_L}), {label}: forward + backward "
              f"{r['fb_ms']:.1f} ms, "
              f"staged {r['staged_ms']:.1f} ms "
              f"({r['staged_ms'] / r['fb_ms']:.1%}) in {r['fb_calls']} calls "
              f"with {r['halo_calls']} halo shifts; gradient sum "
              f"{r['sum_ms']:.1f} ms ({r['sum_staged_ms']:.1f} staged); "
              f"received payload {want['payload'] / 1e6:.3f} MB, grad "
              f"{want['grad'] / 1e6:.1f} MB, meta {want['meta']} B (= the "
              f"shapes); segment_means {sm}, prism_attention {pa} launches;"
              f" loss {r['loss']:.4f}; peak {r['peak_fb_gb']:.2f} GB "
              f"(forward + backward) / {r['peak_gb']:.2f} GB [{card}]",
              flush=True)
    print(f"[train-seq-families] gemma2: {time.perf_counter() - t0:.1f} s with "
          f"rank start-up (the first rematerialised call "
          f"{max(r['warm_s'] for r in ranks):.1f} s of it, before the "
          f"timed step); the ranks' summed gradients and losses "
          f"bit-identical (earlier runs without rematerialisation, "
          f"PERF.md §5: forward + "
          f"backward 3426.0–3500.9 / 2553.9–2563.3 ms, 17.10 GB a rank)",
          flush=True)
    t0 = time.perf_counter()
    ranks = spawn(_hymba_train_rank, LM_P, remat_on, timeout=RANK_TIMEOUT_S)
    cfg = dataclasses.replace(get_config(HYMBA), n_layers=HYMBA_TRAIN_LAYERS)
    n_params = ranks[0]["n_params"]
    for mode in ("voltage", "prism"):
        if len({r["steps"][mode]["digest"] for r in ranks}) != 1:
            raise AssertionError(f"[train-seq-families] hymba {mode}: the "
                                 f"replicas differ")
        for rank, r in enumerate(ranks):
            rows = r["steps"][mode]["rows"]
            want = hymba_train_bytes(cfg, mode, rank, n_params)
            for row in rows:
                _check_bytes(f"[train-seq-families] hymba {mode} rank {rank}",
                             row, want)
                if row["state_calls"] != cfg.n_layers:
                    raise AssertionError(f"[train-seq-families] hymba: "
                                         f"{row['state_calls']} hand-offs")
                sm, pa = row["launches"]
                if mode == "prism":
                    if (sm, pa) != (runs * cfg.n_layers,
                                    runs * cfg.n_layers):
                        raise AssertionError(f"[train-seq-families] hymba "
                                             f"prism: launches {(sm, pa)}")
                    launches["segment_means_hymba"] += sm
                    launches[f"prism_attention_hymba_{rank}"] += pa
            losses = [x["loss"] for x in rows]
            if not all(x == x and abs(x) < 1e9 for x in losses):
                raise AssertionError(f"[train-seq-families] hymba {mode}: "
                                     f"loss {losses}")
            ms = [x["ms"] for x in rows]
            staged = rows[-1]["staged_ms"]
            print(f"[train-seq-families] {HYMBA} cut to {HYMBA_TRAIN_LAYERS}"
                  f" of 32 layers at full width ({n_params / 1e9:.3f} B "
                  f"params bf16, f32 moments) rank {rank} of {LM_P}, B "
                  f"{LM_B} N {LM_N}, {mode}"
                  + ("" if mode == "voltage" else f"(L={LM_L})")
                  + f", {label}"
                  + ": step ms " + ", ".join(f"{x:.1f}" for x in ms)
                  + f"; last step staged {staged:.1f} ms "
                  f"({staged / ms[-1]:.1%}) in {rows[-1]['calls']} calls; "
                  f"received payload {want['payload'] / 1e6:.3f} MB, state "
                  f"{want['state'] / 1e6:.3f} MB, grad "
                  f"{want['grad'] / 1e6:.1f} MB (the state's cotangent "
                  f"{'in it' if rank < LM_P - 1 else 'none: the last rank'})"
                  f", meta {want['meta']} B a step (= the shapes); "
                  f"segment_means {rows[0]['launches'][0]}, prism_attention "
                  f"{rows[0]['launches'][1]} launches a step; loss "
                  + " → ".join(f"{x:.4f}" for x in losses)
                  + f"; replicas bit-identical [{card}]", flush=True)
    print(f"[train-seq-families] hymba: {time.perf_counter() - t0:.1f} s with "
          f"rank start-up (the first rematerialised call "
          f"{max(r['warm_s'] for r in ranks):.1f} s of it); peak "
          f"{max(r['peak_gb'] for r in ranks):.2f} GB a rank (earlier "
          f"runs without rematerialisation, PERF.md §5: 8.78 GB; voltage "
          f"steps 2103.5 / 2230.3 ms, prism 2050.5 / 2042.5 ms)",
          flush=True)
    return launches


def train_family_kernel_rows(tsf: dict, exchange: dict, sk: dict,
                             replaces: dict, keys: tuple) -> list:
    """The kernels line's rows of [train-seq-families]: the forward kernels
    of the gemma2 and hymba train steps, timed at the same shapes in the
    exchange phases (``exchange``: gemma2's part 3; ``sk``: hymba's parts
    0 and 1), their launches summed over the ranks' steps."""
    gnp, np_ = GEMMA_N // GEMMA_P, LM_N // LM_P
    rows = [
        ("segment_means", tsf["segment_means_gemma"],
         exchange["segment_means_gemma"],
         f"{GEMMA} prism train step ({GEMMA_P} ranks, one local/global pair"
         f" at full width): K and V bf16 [1, {gnp}, 16·128] L={GEMMA_L} "
         f"under autograd (explicit PyTorch backward)"),
        ("prism_attention", tsf["prism_attention_gemma"],
         exchange["prism_attention_gemma"],
         f"{GEMMA} prism train step: bf16 [1, {gnp}] 32/16 heads dh=128 "
         f"causal softcap=50 scale=1/12 L={GEMMA_L}, launched on parts "
         f"0-{GEMMA_P - 1}, timed at part {GEMMA_P - 1}"),
        ("segment_means", tsf["segment_means_hymba"], sk["seg"],
         f"{HYMBA} prism train steps ({LM_P} ranks, {HYMBA_TRAIN_LAYERS} "
         f"layers): K and V bf16 [{LM_B}, {np_}, 5·64] L={LM_L}")]
    rows += [("prism_attention", tsf[f"prism_attention_hymba_{p}"],
              sk[f"prism_{p}"],
              f"{HYMBA} prism train steps, rank {p}: bf16 [{LM_B}, {np_}] "
              f"25/5 heads dh=64 (G 5) causal L={LM_L} part {p}")
             for p in range(LM_P)]
    return [{"name": kname, "route": "cuda",
             "source": f"src/repro_torch/kernels/{kname}/csrc/{kname}.cu",
             "replaces": replaces[kname], "launches": n, "shape": shape,
             **{k: t[k] for k in keys}} for kname, n, t, shape in rows]


# --- [dh16]: the kernels at the reduced configs' head width ---------------

# the reduced llama of the examples and launchers: 4/2 heads of 16 (G 2)
DH16_HEADS = (4, 2)
# serve_adaptive's generate: B 2, a prompt of 8 and 8 new tokens
DH16_GEN_B, DH16_GEN_S = 2, 16
# the reduced serving launcher's paged pool in [examples]: ps 8
DH16_PS = 8
# launch.train's reduced default across 2 ranks (vocab 512, B 8, N 128,
# prism(L=4)): [train-seq] runs it, so PRISM attention runs at (16, 16)
DH16_TRAIN = dict(vocab=512, B=8, N=128, L=4, steps=2)


def phase_dh16_kernels() -> dict:
    """Flash-decode (dense and paged, bf16 and f32), segment means at Hk·16
    columns and PRISM attention at (16, 16): the reduced configs' head
    width (every example's and reduced launcher's), each against its plain
    version at the shapes [examples] and the reduced prism train step give
    it and at harder ones (8 splits, fully masked rows, S 1, a window and
    softcap, MHA and G 8, page size 5 with shared pages, the ViT's masked
    exchange); the main shapes timed → {row: kernels-line numbers}."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    H, Hk = DH16_HEADS
    out = {}
    for dtype in (bf16, f32):
        out[("dense", dtype)] = report_timed(
            decode_case(DH16_GEN_B, DH16_GEN_S, 16, dtype, seed=400,
                        heads=DH16_HEADS, lens=[DH16_GEN_S] * DH16_GEN_B),
            "reduced llama generate (dh 16)")
    for label, case in (
            ("bf16 B=1 S=2048 dh=16",
             decode_case(1, 2048, 16, bf16, seed=401, heads=DH16_HEADS)),
            ("f32 B=1 S=2048 dh=16",
             decode_case(1, 2048, 16, f32, seed=402, heads=DH16_HEADS)),
            ("bf16 B=4 S=48 dh=16, row 0 fully masked",
             decode_case(4, 48, 16, bf16, seed=403, heads=DH16_HEADS,
                         masked_row=True)),
            ("f32 B=4 S=48 dh=16, row 0 fully masked",
             decode_case(4, 48, 16, f32, seed=404, heads=DH16_HEADS,
                         masked_row=True)),
            ("bf16 B=1 S=1 dh=16",
             decode_case(1, 1, 16, bf16, seed=405, heads=DH16_HEADS)),
            ("f32 B=2 S=300 dh=16 window=256 softcap=50",
             decode_case(2, 300, 16, f32, seed=406, heads=DH16_HEADS,
                         window=256, softcap=50.0, lens=[300, 290])),
            ("bf16 B=4 S=2048 4/4 heads dh=16 (MHA)",
             decode_case(4, 2048, 16, bf16, seed=407, heads=(4, 4))),
            ("f32 B=4 S=48 8/1 heads dh=16 (G 8)",
             decode_case(4, 48, 16, f32, seed=408, heads=(8, 1)))):
        errs = check_case(case)
        tol = "1e-5" if case["q"].dtype == f32 else "1e-3"
        S, hk = case["k"].shape[1], case["k"].shape[2]
        print(f"[kernel] flash_decode {label}, splits "
              f"{splits_of(case['q'], hk, S)}: err {err_text(errs)} (tol "
              f"{tol})", flush=True)
    for dtype in (bf16, f32):
        name = "bf16" if dtype == bf16 else "f32"
        case = paged_case(8, DH16_PS, 4, 16, dtype, seed=410 + (dtype == f32),
                          heads=DH16_HEADS)
        err = check_paged(f"{name} B=8 ps={DH16_PS} MP=4 dh=16 (the reduced "
                          f"serving launcher's pool)", case)
        t = time_paged(case)
        print(f"[kernel] flash_decode_paged {name} dh=16 timed: kernel "
              f"{t['ms'] * 1e3:.2f} us, bound {t['bound_ms'] * 1e3:.2f} us "
              f"({t['bound_by']}), plain {t['plain_ms'] * 1e3:.2f} us, "
              f"gather + sdpa {t['yardstick_ms'] * 1e3:.2f} us, the dense "
              f"kernel on the gathered cache {t['dense_ms'] * 1e3:.2f} us",
              flush=True)
        out[("paged", dtype)] = dict(t, max_abs_err=err)
    check_paged("bf16 ps=5 MP=12 dh=16, shared pages",
                paged_case(4, 5, 12, 16, bf16, seed=412, shared=True,
                           heads=DH16_HEADS))
    check_paged("f32 ps=8 MP=6 dh=16, row 0 fully masked",
                paged_case(4, 8, 6, 16, f32, seed=413, masked_row=True,
                           heads=DH16_HEADS))
    tr = DH16_TRAIN
    np_ = tr["N"] // LM_P
    seg = seg_case(tr["B"], np_, (Hk, 16), tr["L"], bf16, seed=414,
                   masked=False)
    err = check_seg_kv(f"bf16 K+V [{tr['B']}, {np_}, {Hk}·16] L={tr['L']} "
                       f"(the reduced prism train step)", seg)
    out["seg"] = dict(time_seg(seg), max_abs_err=err)
    check_seg_kv("f32 K+V [4, 100, 4·16] L=20 masked (the reduced ViT's)",
                 seg_case(4, 100, (4, 16), 20, f32, seed=415))
    main = prism_case(tr["B"], np_, H, Hk, 16, LM_P, tr["L"], bf16,
                      seed=416, causal=True, part=1, masked=False,
                      strided=True)
    err = check_prism(f"bf16 (16, 16) [{tr['B']}, {np_}] {H}/{Hk} heads "
                      f"causal L={tr['L']} part 1, strided means (the "
                      f"reduced prism train step)", main)
    t = time_prism(main)
    print(f"[kernel] prism_attention (16, 16) timed: kernel "
          f"{t['ms'] * 1e3:.2f} us ({t['warps']} + 1 warps; 2 CTAs "
          f"{t['split_ms'] * 1e3:.2f} us), bound {t['bound_ms'] * 1e3:.2f} "
          f"us ({t['bound_by']}), plain {t['plain_ms'] * 1e3:.2f} us, sdpa "
          f"{t['library_ms'] * 1e3:.2f} us", flush=True)
    out["prism"] = dict(t, max_abs_err=err)
    for label, case in (
            ("bf16 (16, 16) part 0", prism_case(
                tr["B"], np_, H, Hk, 16, LM_P, tr["L"], bf16, seed=417,
                causal=True, part=0, masked=False, strided=True)),
            ("f32 (16, 16) causal part 1", prism_case(
                tr["B"], np_, H, Hk, 16, LM_P, tr["L"], f32, seed=418,
                causal=True, part=1, masked=False, strided=True)),
            ("bf16 (16, 16) ViT-shaped [4, 100] 4/4 heads masked L=20",
             prism_case(4, 100, 4, 4, 16, 2, 20, bf16, seed=419,
                        strided=True)),
            ("f32 (16, 16) ViT-shaped, batch row 0 sees no key",
             prism_case(4, 100, 4, 4, 16, 2, 20, f32, seed=420,
                        dead_row=True))):
        check_prism(label, case)
    return out


def dh16_kernel_rows(dk: dict, ex: dict, ts: dict, replaces: dict,
                     keys: tuple) -> list:
    """The kernels line's rows at head width 16: flash-decode dense and
    paged in bf16 and f32 (launched by [examples]), segment means and
    PRISM attention at (16, 16) (launched by [mesh]'s reduced prism train
    steps, ``--data 2 --ranks 2``)."""
    import torch
    H, Hk = DH16_HEADS
    tr = DH16_TRAIN
    np_ = tr["N"] // LM_P
    rows = []
    for layout in ("dense", "paged"):
        for dtype in (torch.bfloat16, torch.float32):
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            shape = (f"B={DH16_GEN_B} S={DH16_GEN_S}" if layout == "dense"
                     else f"B=8 ps={DH16_PS} MP=4")
            kname = "flash_decode" + ("_paged" if layout == "paged" else "")
            rows.append((kname, "flash_decode", ex[f"{layout}_{name}"],
                         dk[(layout, dtype)],
                         f"reduced llama {layout} decode at dh 16: {name} "
                         f"{shape} {H}/{Hk} heads ([examples])"))
    rows.append(("segment_means", "segment_means", ts["segment_means_dh16"],
                 dk["seg"], f"reduced llama prism train step ([mesh]'s (2, 2), "
                 f"a data row): K and V bf16 [{tr['B']}, {np_}, {Hk}·16] "
                 f"L={tr['L']}"))
    rows.append(("prism_attention", "prism_attention",
                 ts["prism_attention_dh16"], dk["prism"],
                 f"reduced llama prism train step ([mesh]'s (2, 2), a data "
                 f"row): bf16 [{tr['B']}, {np_}] {H}/{Hk} heads, widths (16, "
                 f"16), causal"
                 f" L={tr['L']} part 1"))
    return [{"name": kname, "route": "cuda",
             "source": f"src/repro_torch/kernels/{src}/csrc/{src}.cu",
             "replaces": replaces[kname], "launches": n, "shape": shape,
             **{k: t[k] for k in keys}} for kname, src, n, t, shape in rows]


# --- [mesh]: the (data, model) mesh, ZeRO over data, the re-mesh ----------

MESH_SHAPE, MESH_NAMES = (2, 2), ("data", "model")
MESH_B = 2 * LM_B           # each data row [train-seq]'s B 4 on 2 ranks
MESH_STEPS = 3              # the reduced run's; the checkpoint at step 2
MESH_REMESH_RTOL = 1e-2     # step 3 resumed on (1, 2) vs uninterrupted, bf16
MESH_SMALL_B, MESH_SMALL_N, MESH_SMALL_L, MESH_SMALL_STEPS = 4, 32, 4, 2
MESH_TP_STEPS = 1           # (c): local TP at full width, after the warm-ups
                            # (a step takes 5.1–5.8 s: PERF.md §5)
MESH_MOE = "deepseek-moe-16b"     # the reduced moe warm-up, batch over data
# (d): build_decode_step at full width, all 16 layers, f32 (greedy tokens
# exact against one rank of the card), a prompt teacher-forced, then greedy
MESH_DEC_B, MESH_DEC_T0, MESH_DEC_NEW = 8, 8, 8
# (e), (f): local TP of the heads the even split cannot take, at full
# width in f32: deepseek-v2-236b cut to 2 of 60 layers (layer 0 dense,
# layer 1 MoE; MLA split by heads, 64 of 128 a rank, and its latents by
# columns) and hymba-1.5b cut to 4 of 32 (25/5 heads split 15/10 by whole
# KV groups, its Mamba by inner channel), (g) xlstm-350m cut to one of its
# 3 groups (7 mLSTM by value channel, 1 sLSTM by head); a prefill, then
# greedy decode (B MESH_DEC_B, the prompt teacher-forced), against rank 0
# alone on the whole params; hymba's and xLSTM's train steps beside the
# dry run's count (xLSTM's at B MESH_XLSTM_B N MESH_XLSTM_N, for its time
# loops' seconds: N within its remat chunk of 128, 8.77 GB a rank counted)
MESH_TP_HEADS = {"(e)": (MLA_ARCH, 2), "(f)": ("hymba-1.5b", 4),
                 "(g)": ("xlstm-350m", 8)}
MESH_TP_NEW = 4
# a decode plan with fsdp gathers every layer each step over gloo (10.7–15.6
# s a step for deepseek-v2's 2 layers in f32, 4 ranks sharing one H100 80GB
# at 700 W): (e)'s prompt is one token, so its MESH_TP_NEW greedy tokens
# take 5 steps in all
MESH_FSDP_T0 = 1
MESH_XLSTM_B, MESH_XLSTM_N = 4, 128


def mesh_dry_runs(runs: dict) -> dict:
    """``mesh_dry_run`` of each of ``runs`` (label → the launcher's
    arguments) on MESH_SHAPE, in turn."""
    return {k: mesh_dry_run(a, MESH_SHAPE) for k, a in runs.items()}


def mesh_dry_run(a: dict, shape) -> dict:
    """The dry run (``repro_torch.launch.dryrun``: meta tensors, abstract
    collectives, this process) of launch.train's mesh step for the
    launcher's arguments ``a``, at every rank of ``shape`` → (data, model)
    → (bytes by kind, calls, peak GB, trace s).  Counted, not
    measured."""
    from repro_torch.core.exchange import ExchangeMode
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.mesh import make_auto_mesh
    from repro_torch.launch.train import model_config
    cfg, mesh = model_config(a), make_auto_mesh(shape, MESH_NAMES)
    out = {}
    for d in range(shape[0]):
        for m in range(shape[1]):
            got = trace_step(cfg, "train", mesh,
                             mode=ExchangeMode(a["mode"]), B=a["batch"],
                             N=a["seq"], L=a["L"],
                             coords={"data": d, "model": m})
            g = got["gather"]
            out[(d, m)] = ({f[:-6]: v for f, v in g.items()
                            if f.endswith("_bytes")}, g["calls"],
                           got["peak_bytes"] / 1e9, got["trace_s"])
    return out


def check_dry_run(label: str, ranks, dry: dict, card: str) -> None:
    """Every step of every rank received the bytes by kind and made the
    calls that the dry run at its coordinates counts; its peak printed
    beside the measured one."""
    for r in ranks:
        c = r["coords"]
        want, calls, peak, secs = dry[(c["data"], c["model"])]
        for row in r["rows"]:
            got = {k: row.get(k, 0) for k in want}
            if got != want or row["calls"] != calls:
                raise AssertionError(f"[mesh] {label} rank {c}: bytes "
                                     f"{got}, {row['calls']} calls; the dry "
                                     f"run counts {want}, {calls} calls")
        print(f"[mesh] {label} rank {c}: the dry run (launch.dryrun on the "
              f"meta device in this process, {secs:.1f} s) counts "
              + ", ".join(f"{k} {v} B" for k, v in want.items() if v)
              + f" in {calls} calls a step = the rank's measured rows; rank "
              f"peak {peak:.2f} GB counted, {r['peak_gb']:.2f} GB measured "
              f"[{card}]", flush=True)


def _check_mesh_run(ranks, a: dict, shape, label: str,
                    want_launches: int, dry):
    """The ranks' results of ``launch.train``'s mesh path (``train_mesh``)
    with the launcher's arguments ``a`` on ``shape``: each step's bytes by
    kind and calls equal to the dry run's count at the rank's coordinates
    (``dry``, ``mesh_dry_run``'s; False: not checked), each step's kernel
    launches ``want_launches`` of each, every block the same on the ranks
    that hold it and the whole params the same on every rank, the losses
    finite → the config."""
    from repro_torch.launch.train import check_mesh, model_config
    cfg = model_config(a)
    bad = check_mesh(ranks)
    if bad:
        raise AssertionError(f"[mesh] {label}: {bad}")
    for r in ranks:
        c = r["coords"]
        want, calls = dry[(c["data"], c["model"])][:2] if dry else ({}, 0)
        for row in r["rows"]:
            got = {k: row.get(k, 0) for k in want}
            if dry and (got != want or row["calls"] != calls):
                raise AssertionError(f"[mesh] {label} rank {c}: bytes "
                                     f"{row} != {want} in {calls} calls, the "
                                     f"dry run's count")
            if row["launches"] != (want_launches, want_launches):
                raise AssertionError(f"[mesh] {label}: launches "
                                     f"{row['launches']} a step, want "
                                     f"{want_launches} of each")
        if not all(x == x and abs(x) < 1e9 for x in r["losses"]):
            raise AssertionError(f"[mesh] {label}: loss {r['losses']}")
    return cfg


def _print_mesh_ranks(label: str, ranks, card: str) -> None:
    for r in ranks:
        rows = r["rows"]
        steady = list(range(1, len(rows))) or [0]
        ms = statistics.median(r["ms"][i] for i in steady)
        st = statistics.median(r["staged_ms"][i] for i in steady)
        last = rows[-1]
        print(f"[mesh] {label} rank {r['coords']}: step ms "
              + ", ".join(f"{x:.1f}" for x in r["ms"])
              + f"; steady {ms:.1f} ms, staged {st:.1f} ms ({st / ms:.1%}) "
              f"in {last['calls']} calls; received payload "
              f"{last['payload'] / 1e6:.3f} MB, meta {last['meta']} B, grad "
              f"{last['grad'] / 1e6:.1f} MB, param {last['param'] / 1e6:.1f} "
              f"MB, tp {last.get('tp', 0) / 1e6:.1f} MB a step (= the "
              f"dry run's count); segment_means "
              f"{last['launches'][0]}, prism_attention {last['launches'][1]}"
              f" launches a step; loss "
              + " → ".join(f"{x:.4f}" for x in r["losses"])
              + f"; peak {r['peak_gb']:.2f} GB [{card}]", flush=True)


def _mesh_small(rank, world):
    """A small f32 llama on this rank of the (2, 2) mesh, on the card and
    then on the CPU (the same seed-0 weights and batches): each step's
    loss and gradient (summed over the mesh, gathered whole) and the
    params gathered whole after MESH_SMALL_STEPS steps, with the kernels'
    launches on the card."""
    _exact_fp32()
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.exchange import ExchangeMode
    from repro_torch.kernels.prism_attention import prism_attention
    from repro_torch.kernels.segment_means import segment_means
    from repro_torch.launch.mesh import get_abstract_mesh
    from repro_torch.models import registry
    from repro_torch.sharding.placement import Placement
    from repro_torch.sharding.specs import make_plan
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import mesh_gradients, mesh_update
    cfg = get_config(ARCH).reduced(**SMALL_LLAMA)
    params0 = registry.init_params(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(7)
    batches = [{k: rng.randint(0, cfg.vocab_size, (MESH_SMALL_B,
                                                   MESH_SMALL_N))
                for k in ("tokens", "labels")}
               for _ in range(MESH_SMALL_STEPS)]
    plan = make_plan(get_abstract_mesh(), cfg, ExchangeMode.PRISM,
                     L=MESH_SMALL_L, train=True)
    place = Placement(plan, cfg, registry.abstract_params(cfg))
    out = {}
    for dev in ("cuda", "cpu"):
        blocks, opt = place.init_state(_on(params0, dev))
        before = (segment_means.launches, prism_attention.launches)
        steps = []
        for b in batches:
            batch = {k: torch.from_numpy(v.astype(np.int32)).to(dev)
                     for k, v in b.items()}
            loss, _, g = mesh_gradients(blocks, batch, cfg, place)
            grads = place.whole(g, place.opt_spec)
            blocks, opt, _ = mesh_update(blocks, opt, g, place,
                                         OptConfig(**TRAIN_OPT))
            steps.append(dict(loss=float(loss), grads={
                k: v.float().cpu().numpy() for k, v in grads.items()}))
        whole = place.whole(blocks, place.spec)
        out[dev] = dict(steps=steps, launches=(
            segment_means.launches - before[0],
            prism_attention.launches - before[1]),
            params={k: v.float().cpu().numpy() for k, v in whole.items()},
            shard_digest=_digest([blocks[k] for k in place.keys]),
            digest=_digest(list(whole.values())))
    out["coords"] = place.coords
    return out


def _greedy(step, params, cache, prompt, col, n_new: int):
    """``prompt`` [B, T0] teacher-forced through the decode ``step``, then
    ``n_new`` greedy steps; each step's tokens gathered over the column
    ``col`` (None: the rank holds every row) → (the greedy tokens [B,
    n_new], each step's ms on the host clock to its synchronise)."""
    import time
    import torch
    B, T0 = prompt.shape
    tok, tokens, ms = prompt[:, :1], [], []
    for i in range(T0 + n_new - 1):
        t0 = time.perf_counter()
        logits, cache = step(params, {"tokens": tok}, cache, i)
        mine = logits[:, -1].argmax(-1)
        if prompt.is_cuda:
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        got = mine if col is None else torch.cat(
            [torch.as_tensor(t) for t in col.all_gather_object(
                mine.cpu().numpy())]).to(prompt.device)
        tok = (prompt[:, i + 1:i + 2] if i + 1 < T0
               else got[:, None].to(prompt.dtype))
        if i + 1 >= T0:
            tokens.append(got.cpu())
    return torch.stack(tokens, 1).numpy(), ms


def _mesh_decode(rank, world):
    """[mesh] (d): the serving engine's ``build_decode_step`` on this rank
    of the (2, 2) mesh, llama3.2-1b at full width and depth in f32 (every
    rank draws the seed-0 weights; ``Placement.held_params`` keeps its
    blocks), B MESH_DEC_B: under ``local`` TP (its 4 of 8 rows, 16/4 heads,
    its MLP columns and vocabulary rows) and under ``prism(L=16)`` (the
    cache sequence-sharded over the row, the MLP split over it); rank 0
    then runs the same steps alone on the whole params → the greedy tokens,
    flash-decode launches, step ms and bytes of each."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.exchange import ExchangeConfig, ExchangeMode
    from repro_torch.core.seq_group import get_seq_group
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.launch.mesh import get_abstract_mesh
    from repro_torch.launch.train import _received
    from repro_torch.models import registry
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import engine
    from repro_torch.sharding.placement import Placement
    from repro_torch.sharding.specs import make_plan
    _exact_fp32()
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    params = registry.init_params(cfg, seed=0, device="cuda")
    prompt = torch.from_numpy(np.random.RandomState(11).randint(
        0, cfg.vocab_size, (MESH_DEC_B, MESH_DEC_T0)).astype(np.int32)).cuda()
    S = MESH_DEC_T0 + MESH_DEC_NEW
    mesh = get_abstract_mesh()
    groups = [get_seq_group(a) for a in mesh.axis_names]
    out = {}
    with torch.no_grad():
        for mode, L in (("local", 0), ("prism", LM_L)):
            plan = make_plan(mesh, cfg, ExchangeMode(mode), L=L, decode=True)
            place = Placement(plan, cfg, registry.abstract_params(cfg))
            view = place.held_params(params)
            cache = engine.init_cache(cfg, plan, MESH_DEC_B, S, "cuda")
            step = engine.build_decode_step(cfg, plan.xcfg, plan)
            for g in groups:
                g.reset_stats()
            before = flash_decode.launches
            tokens, ms = _greedy(step, view, cache, prompt, groups[0],
                                 MESH_DEC_NEW)
            out[mode] = dict(tokens=tokens, ms=ms,
                             launches=flash_decode.launches - before,
                             got=_received(groups),
                             split=len(place.tp_dim),
                             kv_heads=tuple(cache[next(iter(cache))]["k"]
                                            .shape))
            del view, cache
            gc.collect()
            torch.cuda.empty_cache()
        if rank == 0:
            cache = tfm.init_decode_cache(cfg, MESH_DEC_B, S, device="cuda")
            step = engine.build_decode_step(cfg, ExchangeConfig())
            out["one"] = dict(zip(("tokens", "ms"), _greedy(
                step, params, cache, prompt, None, MESH_DEC_NEW)))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _seeded_leaf(path, leaf, seed: int):
    """One f32 leaf of ``_seeded_params`` on the card, drawn whole from its
    own seed (``seed`` and its path)."""
    import zlib
    import torch
    name = "/".join(map(str, path))
    if leaf.ndim < 2:
        return torch.zeros(leaf.shape, dtype=torch.float32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(
        seed * 1000003 + zlib.crc32(name.encode()))
    fan_in = leaf.shape[-3] if name.endswith(("w_uk", "w_uv")) \
        else leaf.shape[-2]
    return torch.randn(leaf.shape, generator=g, device="cuda",
                       dtype=torch.float32).mul_(
        0.02 if name.endswith("table") else fan_in ** -0.5)


def _seeded_params(cfg, seed: int, place=None):
    """f32 random weights of ``cfg`` on the card, each leaf drawn whole
    from its own seed (``seed`` and its path) one at a time: matrices
    N(0, 1/fan_in) (the embeddings N(0, 0.02²)), vectors and scalars 0;
    with ``place`` (a ``Placement``) only the block the rank's model runs
    on is kept (its ``held_index``), or under a plan with ``fsdp`` the
    rank's param-spec blocks (``_seeded_blocks``).  Every rank draws the
    same leaves, and no rank ever holds more than its view and one whole
    leaf."""
    from repro_torch.models import registry
    from repro_torch.utils.tree import (tree_leaves_with_paths,
                                        tree_unflatten_like)
    if place is not None and place.plan.fsdp:
        return _seeded_blocks(seed, place)
    template = registry.abstract_params(cfg)
    where = {} if place is None else {
        p: (k, ent.lead) for k, ent in place.index_of.items()
        for p in ent.paths}
    out = []
    for path, leaf in tree_leaves_with_paths(template):
        t = _seeded_leaf(path, leaf, seed)
        if place is not None:
            k, lead = where[path]
            t = t[place.held_index(k)[lead:]].clone()
        out.append(t)
    return tree_unflatten_like(template, out)


def _seeded_blocks(seed: int, place) -> dict:
    """``_seeded_params``' leaves as this rank's param-spec blocks under
    ``place`` (JAX-layout key → block; a ZeRO-3 serving step's
    params), each leaf of each owned layer drawn whole and cut."""
    import torch
    from repro_torch.sharding.placement import _unravel
    from repro_torch.utils.tree import tree_leaves_with_paths
    leaves = dict(tree_leaves_with_paths(place.template))
    out = {}
    for k, ent in place.index_of.items():
        idx = place.index(k, place.spec[k])
        rows = [j for j in range(len(ent.paths))
                if all(s.start <= m < s.stop for s, m in zip(
                    idx, _unravel(j, ent.shape[:ent.lead])))]
        parts = [_seeded_leaf(ent.paths[j], leaves[ent.paths[j]],
                              seed)[idx[ent.lead:]].clone() for j in rows]
        out[k] = torch.stack(parts).reshape(place.block_shape(
            k, place.spec[k]))
    return out



def _tp_heads_cfg(label: str):
    import dataclasses
    from repro_torch.configs import get_config
    arch, layers = MESH_TP_HEADS[label]
    return dataclasses.replace(get_config(arch), n_layers=layers,
                               dtype="float32")


def tp_view_bytes(label: str, shape) -> dict:
    """(e)/(f) reckoned before the spawn, from the shapes: the bytes of
    the f32 tree each rank of ``shape`` runs on under the ``local`` decode
    plan (by model coordinate; its param-spec blocks where the plan has
    ``fsdp``), and of the whole params."""
    import numpy as np
    from repro_torch.core.exchange import ExchangeMode
    from repro_torch.launch.mesh import make_auto_mesh
    from repro_torch.models import registry
    from repro_torch.sharding.placement import Placement
    from repro_torch.sharding.specs import make_plan
    cfg = _tp_heads_cfg(label)
    meta = registry.abstract_params(cfg)
    plan = make_plan(make_auto_mesh(shape, MESH_NAMES), cfg,
                     ExchangeMode.LOCAL, decode=True)
    out = {}
    for m in range(shape[1]):
        pl = Placement(plan, cfg, meta, coords={"data": 0, "model": m})
        out[m] = sum(4 * int(np.prod(pl.block_shape(k, pl.spec[k])
                                     if plan.fsdp else pl.held_shape(k)))
                     for k in pl.keys)
    out["whole"] = sum(4 * int(np.prod(e.shape))
                       for e in pl.index_of.values())
    return out


def _mesh_tp_heads(rank, world, label: str):
    """[mesh] (e) or (f) on this rank of the (2, 2) mesh: ``_tp_heads_cfg``
    under the ``local`` decode plan (the rank's heads, MLP columns or
    experts, vocabulary rows; its rows of the batch): ``build_prefill_step``
    on the prompt, then ``build_decode_step`` greedy from an empty cache
    (the prompt teacher-forced, MESH_TP_NEW new tokens; a plan with
    ``fsdp``, on the rank's blocks: a prompt of MESH_FSDP_T0); the
    ranks draw
    their views one at a time, free them, and rank 0 runs the same steps
    alone on the whole params → the tokens, the prefill's greedy token,
    flash-decode launches, step ms, bytes received, the view's GB and the
    cache's KV heads."""
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.exchange import ExchangeConfig, ExchangeMode
    from repro_torch.core.seq_group import get_seq_group
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.launch.mesh import get_abstract_mesh
    from repro_torch.launch.train import _received
    from repro_torch.models import registry
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import engine
    from repro_torch.sharding.placement import Placement
    from repro_torch.sharding.specs import make_plan
    _exact_fp32()
    torch.cuda.reset_peak_memory_stats()
    cfg = _tp_heads_cfg(label)
    seeded = cfg.family == "moe"          # deepseek-v2: 21 GB whole in f32
    mesh = get_abstract_mesh()
    groups = [get_seq_group(a) for a in mesh.axis_names]
    plan = make_plan(mesh, cfg, ExchangeMode.LOCAL, decode=True)
    place = Placement(plan, cfg, registry.abstract_params(cfg))
    for turn in range(world):             # one whole draw at a time
        if turn == rank:
            view = _seeded_params(cfg, 0, place) if seeded else \
                registry.init_params(cfg, seed=0, device="cuda")
            if not seeded:
                view = (place.param_blocks(view) if plan.fsdp
                        else place.held_params(view))
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    prompt = torch.from_numpy(np.random.RandomState(13).randint(
        0, cfg.vocab_size, (MESH_DEC_B, MESH_DEC_T0)).astype(np.int32)).cuda()
    new = MESH_TP_NEW
    if plan.fsdp:
        prompt = prompt[:, :MESH_FSDP_T0]
    S = prompt.shape[1] + new

    def first_token(step, params, cache, col):
        logits, _ = step(params, {"tokens": prompt}, cache)
        mine = logits[:, -1].argmax(-1).cpu()
        return mine.numpy() if col is None else torch.cat(
            [torch.as_tensor(t) for t in col.all_gather_object(
                mine.numpy())]).numpy()
    for g in groups:
        g.reset_stats()
    before = flash_decode.launches
    with torch.no_grad():
        first = first_token(engine.build_prefill_step(cfg, plan.xcfg, plan),
                            view, engine.init_cache(cfg, plan, MESH_DEC_B, S,
                                                    "cuda"), groups[0])
        cache = engine.init_cache(cfg, plan, MESH_DEC_B, S, "cuda")
        tokens, ms = _greedy(engine.build_decode_step(cfg, plan.xcfg, plan),
                             view, cache, prompt, groups[0], new)
    out = dict(tokens=tokens, ms=ms, first=first,
               launches=flash_decode.launches - before,
               got=_received(groups), coords=place.coords,
               view_gb=sum(t.numel() * 4 for t in _leaves(view)) / 1e9,
               fsdp=plan.fsdp, t0=prompt.shape[1], new=new,
               cache=_cache_shape(cache),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del view, cache
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()                        # every view freed first
    if rank == 0:
        whole = (_seeded_params(cfg, 0) if seeded else
                 registry.init_params(cfg, seed=0, device="cuda"))
        one = ExchangeConfig()
        with torch.no_grad():
            out["one"] = dict(first=first_token(
                engine.build_prefill_step(cfg, one), whole,
                tfm.init_decode_cache(cfg, MESH_DEC_B, S, device="cuda"),
                None))
            out["one"]["tokens"], out["one"]["ms"] = _greedy(
                engine.build_decode_step(cfg, one), whole,
                tfm.init_decode_cache(cfg, MESH_DEC_B, S, device="cuda"),
                prompt, None, new)
        del whole
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def _cache_shape(cache) -> tuple:
    """The shape of a decode cache's first K (dense), latent (MLA) or mLSTM
    matrix memory (xLSTM) leaf: the rank's heads or channels."""
    for half in cache.values():
        if isinstance(half, dict):
            for name in ("k", "c_kv", "C", "h"):
                if name in half:
                    return tuple(half[name].shape)
    raise ValueError("no cache leaf to show")


def _mesh_rank(rank, world, reduced: dict, full: dict, tp_runs: dict):
    """One rank of [mesh]'s (2, 2) mesh: launch.train's reduced run (which
    also warms the rank up: the first rematerialised call, the kernels'
    libraries), the reduced ``local`` TP runs (llama, then the moe family
    with its batch over data), the full-width ``prism`` run (a), the
    full-width ``local`` TP run (c), the small f32 case, (d), hymba's and
    xLSTM's ``local`` TP train steps (f), (g), then the decode runs of (e),
    (f) and (g)."""
    import gc
    import torch
    from repro_torch.launch.train import train_mesh
    out = dict(reduced=train_mesh(rank, world, reduced))
    out["tp_reduced"] = train_mesh(rank, world, tp_runs["reduced"])
    out["tp_moe"] = train_mesh(rank, world, tp_runs["moe"])
    out["full"] = train_mesh(rank, world, full)
    gc.collect()
    torch.cuda.empty_cache()
    out["tp_full"] = train_mesh(rank, world, tp_runs["full"])
    gc.collect()
    torch.cuda.empty_cache()
    out["small"] = _mesh_small(rank, world)
    gc.collect()
    torch.cuda.empty_cache()
    out["decode"] = _mesh_decode(rank, world)
    gc.collect()
    torch.cuda.empty_cache()
    out["tp_hymba"] = train_mesh(rank, world, tp_runs["hymba"])
    gc.collect()
    torch.cuda.empty_cache()
    out["tp_xlstm"] = train_mesh(rank, world, tp_runs["xlstm"])
    gc.collect()
    torch.cuda.empty_cache()
    out["heads"] = {label: _mesh_tp_heads(rank, world, label)
                    for label in MESH_TP_HEADS}
    return out


def mesh_tp_kernels() -> dict:
    """The flash-decode launches of [mesh] (d), each against its plain
    version and timed (f32, the last greedy step's cache lengths): under
    ``local`` TP a rank's B 4 rows at 16/4 heads of 64 over S 16; under
    ``prism(L=16)`` the shard partial of rank 1 (B 4, Sp 8 of S 16, 32/8
    heads)."""
    import torch
    f32, S = torch.float32, MESH_DEC_T0 + MESH_DEC_NEW
    b = MESH_DEC_B // MESH_SHAPE[0]
    local = decode_case(b, S, 64, f32, seed=70, heads=(N_HEADS // 2,
                                                       N_KV // 2),
                        lens=[S - 1] * b)
    t_local = report_timed(local, f"[mesh] (d) local TP decode step per "
                                  f"rank ({N_HEADS // 2}/{N_KV // 2} heads, "
                                  f"G 4)")
    shard = shard_case(b, S, MESH_SHAPE[1], 1, 64, f32, seed=71,
                       lens=[S - 1] * b)
    errs = check_case(shard, got=shard_partials(shard))
    t_prism = dict(time_case(shard), max_abs_err=errs["max_abs_err"])
    print(f"[kernel] flash_decode shard partial, [mesh] (d) prism(L="
          f"{LM_L}) decode step per rank (rank 1: f32 B {b}, Sp {S // 2} of "
          f"S {S}, offset {S // 2}, {S // 2 - 1} valid, {N_HEADS}/{N_KV} "
          f"heads, dh 64): err {err_text(errs)} (tol 1e-5) | kernel "
          f"{t_prism['ms']*1e3:.2f} us, bound {t_prism['bound_ms']*1e3:.2f} "
          f"us ({t_prism['bound_by']}), plain {t_prism['plain_ms']*1e3:.2f} "
          f"us, sdpa yardstick {t_prism['library_ms']*1e3:.2f} us",
          flush=True)
    return {"local": t_local, "prism": t_prism}


def mesh_heads_kernels() -> dict:
    """The flash-decode launches of [mesh] (f), each against its plain
    version and timed (f32, the last greedy step's cache lengths): a
    rank's B 4 rows (a data row) at hymba-1.5b's heads split by whole KV
    groups, 15/3 on model rank 0 and 10/2 on rank 1 (G 5, dh 64) → by
    model rank."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.tp import head_split
    c = get_config(MESH_TP_HEADS["(f)"][0])
    S, b = MESH_DEC_T0 + MESH_TP_NEW, MESH_DEC_B // MESH_SHAPE[0]
    out = {}
    for m in range(MESH_SHAPE[1]):
        h = head_split(c.n_heads, c.n_kv_heads, MESH_SHAPE[1], m)
        case = decode_case(b, S, c.hd, torch.float32, seed=80 + m,
                           heads=(h.n_q, h.n_kv), lens=[S - 1] * b)
        out[m] = dict(report_timed(
            case, f"[mesh] (f) {c.name} local TP decode step, model rank "
                  f"{m} ({h.n_q}/{h.n_kv} heads, G {h.n_q // h.n_kv})"),
            heads=(h.n_q, h.n_kv))
    return out


def _check_tp_heads(label: str, runs, card: str) -> dict:
    """(e)/(f)'s decode on every rank against rank 0 alone: the prefill's
    greedy token and the greedy tokens equal; (f)'s flash-decode launched
    on every rank → launches by model rank."""
    cfg = _tp_heads_cfg(label)
    one = runs[0]["one"]
    launches = {}
    for r in runs:
        m = r["coords"]["model"]
        if not ((r["tokens"] == one["tokens"]).all()
                and (r["first"] == one["first"]).all()):
            raise AssertionError(f"[mesh] {label}: greedy tokens "
                                 f"{r['tokens'].tolist()} (prefill "
                                 f"{r['first'].tolist()}) vs one rank's "
                                 f"{one['tokens'].tolist()} "
                                 f"({one['first'].tolist()})")
        if cfg.mla is None and cfg.family != "ssm" and r["launches"] == 0:
            raise AssertionError(f"[mesh] {label}: no flash-decode launch")
        launches[m] = launches.get(m, 0) + r["launches"]
    for r in runs[:MESH_SHAPE[1]]:
        print(f"[mesh] {label} {cfg.name} cut to {cfg.n_layers} of its "
              f"layers at full width, f32, local TP on (2, 2), rank "
              f"{r['coords']}: "
              + (f"its ZeRO-3 blocks {r['view_gb']:.2f} GB (each layer "
                 f"gathered as the loop reaches it: param "
                 f"{r['got'].get('param', 0) / 1e6:.1f} MB received)"
                 if r["fsdp"] else f"view {r['view_gb']:.2f} GB")
              + f", cache "
              f"{list(r['cache'])}; prefill + {r['t0']} prompt steps + "
              f"{r['new']} greedy: tokens = one rank's exactly (prefill "
              f"too); {r['launches']} flash-decode launches; step "
              f"{statistics.median(r['ms'][1:]):.1f} ms (median; one rank "
              f"alone {statistics.median(one['ms'][1:]):.1f} ms), received "
              f"tp {r['got'].get('tp', 0) / 1e6:.3f} MB in "
              f"{r['got']['calls']} calls ({r['got']['seconds'] * 1e3:.1f} "
              f"ms staged); peak {r['peak_gb']:.2f} GB [{card}]", flush=True)
    return launches


def phase_mesh(card: str) -> dict:
    """``[mesh]``, on one (2, 2) spawn of 4 ranks sharing the card:
    launch.train's reduced llama ``--data 2 --ranks 2`` (PRISM attention
    at (16, 16); MESH_STEPS steps, the checkpoint at step 2), then (a)
    llama3.2-1b cut to TRAIN_SEQ_LAYERS layers at full width,
    ``prism(L=16)``, B 8 N 512, 2 steps, then a small f32 llama on the card
    against the CPU; (b) the re-mesh, on the reduced config ((a) and (b)
    at full width took 171.5 s on the card, PERF.md §6): an
    ``ElasticMeshManager`` over ranks 0–3 drops 2 and 3, and the survivors
    resume as its (1, 2) mesh from the step-2 checkpoint and take step 3,
    held to the uninterrupted run's step 3 → the kernels' launches summed
    over the ranks: the full-width runs' and the reduced runs' (``_dh16``,
    the (2, 2) run's)."""
    import gc
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core.exchange import ExchangeMode
    from repro_torch.core.seq_group import spawn_mesh
    from repro_torch.launch.train import model_config, train_mesh
    from repro_torch.runtime.elastic import ElasticMeshManager
    gc.collect()
    torch.cuda.empty_cache()       # 4 ranks share the card with this process
    ck = tempfile.mkdtemp(prefix="mesh_ckpt_")
    tr = DH16_TRAIN
    red = dict(arch=ARCH, steps=MESH_STEPS, mode="prism", ranks=MESH_SHAPE[1],
               data=MESH_SHAPE[0], batch=MESH_SHAPE[0] * tr["B"],
               seq=tr["N"], L=tr["L"], full=False, layers=None,
               device="cuda", ckpt_dir=ck, ckpt_every=2, resume=False)
    full = dict(red, steps=2, batch=MESH_B, seq=LM_N, L=LM_L, full=True,
                layers=TRAIN_SEQ_LAYERS, ckpt_dir=os.path.join(ck, "full"),
                ckpt_every=50)
    tp = {"reduced": dict(red, mode="local", steps=2, ckpt_every=50,
                          ckpt_dir=os.path.join(ck, "tp")),
          "moe": dict(red, arch=MESH_MOE, mode="local", steps=2,
                      ckpt_every=50, ckpt_dir=os.path.join(ck, "moe")),
          "full": dict(full, mode="local", steps=MESH_TP_STEPS,
                       ckpt_dir=os.path.join(ck, "tp_full")),
          "hymba": dict(full, arch=MESH_TP_HEADS["(f)"][0], mode="local",
                        steps=MESH_TP_STEPS,
                        layers=MESH_TP_HEADS["(f)"][1],
                        ckpt_dir=os.path.join(ck, "tp_hymba")),
          "xlstm": dict(full, arch=MESH_TP_HEADS["(g)"][0], mode="local",
                        steps=MESH_TP_STEPS, batch=MESH_XLSTM_B,
                        seq=MESH_XLSTM_N,
                        layers=MESH_TP_HEADS["(g)"][1],
                        ckpt_dir=os.path.join(ck, "tp_xlstm"))}
    for label in MESH_TP_HEADS:               # (e), (f): a rank's view
        v = tp_view_bytes(label, MESH_SHAPE)
        print(f"[mesh] {label} reckoned from the shapes: a rank runs on "
              + ", ".join(f"{v[m]} B (model rank {m})"
                          for m in range(MESH_SHAPE[1]))
              + f" of the {v['whole']} B of f32 params", flush=True)
    try:
        t0 = time.perf_counter()
        with concurrent.futures.ProcessPoolExecutor(
                2, mp_context=multiprocessing.get_context("spawn")) as pool:
            # the dry runs in two processes while the ranks run: (g)'s time
            # loops in one, the others in the other (the counts every
            # step's bytes and calls are held to)
            dry_g = pool.submit(mesh_dry_run, tp["xlstm"], MESH_SHAPE)
            dry = pool.submit(mesh_dry_runs, {
                "reduced": red, "reduced local TP": tp["reduced"],
                "(a)": full, "(c)": tp["full"], "(f)": tp["hymba"]})
            dry_b = pool.submit(mesh_dry_run, dict(red, data=1), (1, 2))
            ranks = spawn_mesh(_mesh_rank, MESH_SHAPE, MESH_NAMES, red, full,
                               tp, timeout=RANK_TIMEOUT_S)
            dry = dict(dry.result(), **{"(g)": dry_g.result(),
                                        "(b)": dry_b.result()})
        spawn_s = time.perf_counter() - t0
        rcfg = _check_mesh_run([r["reduced"] for r in ranks], red,
                               MESH_SHAPE, "reduced",
                               2 * model_config(red).n_layers,
                               dry["reduced"])
        _check_mesh_run([r["full"] for r in ranks], full, MESH_SHAPE, "(a)",
                        2 * TRAIN_SEQ_LAYERS, dry["(a)"])
        _check_mesh_run([r["tp_reduced"] for r in ranks], tp["reduced"],
                        MESH_SHAPE, "reduced local TP", 0,
                        dry["reduced local TP"])
        _check_mesh_run([r["tp_moe"] for r in ranks], tp["moe"], MESH_SHAPE,
                        "reduced moe local TP", 0, False)
        _check_mesh_run([r["tp_full"] for r in ranks], tp["full"],
                        MESH_SHAPE, "(c)", 0, dry["(c)"])
        _check_mesh_run([r["tp_hymba"] for r in ranks], tp["hymba"],
                        MESH_SHAPE, "(f)", 0, False)
        _check_mesh_run([r["tp_xlstm"] for r in ranks], tp["xlstm"],
                        MESH_SHAPE, "(g)", 0, False)
        mgr = ElasticMeshManager(rcfg, ExchangeMode.PRISM, L=tr["L"],
                                 devices=[0, 1, 2, 3])
        mesh, plan = mgr.drop([2, 3])
        shape = tuple(mesh.shape.values())
        if shape != (1, 2) or plan.xcfg.seq_shards != 2:
            raise AssertionError(f"[mesh] (b): best_mesh {mesh} after "
                                 f"dropping ranks 2, 3")
        t0 = time.perf_counter()
        b = dict(red, data=1, resume=True)
        sur = spawn_mesh(train_mesh, shape, MESH_NAMES, b,
                         timeout=RANK_TIMEOUT_S)
        remesh_s = time.perf_counter() - t0
        _check_mesh_run(sur, b, shape, "(b)", 2 * rcfg.n_layers, dry["(b)"])
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    fr = [r["full"] for r in ranks]
    print(f"[mesh] (a) {ARCH} cut to {TRAIN_SEQ_LAYERS} of 16 layers at "
          f"full width on a {dict(zip(MESH_NAMES, MESH_SHAPE))} mesh of 4 "
          f"ranks sharing the card, prism(L={LM_L}), B {MESH_B} N {LM_N} (B "
          f"{MESH_B // MESH_SHAPE[0]} a data row, as [train-seq]'s 2 ranks), "
          f"params ZeRO-3 over data, AdamW state ZeRO-1 over both axes, 2 "
          f"steps after the reduced run's warm-up; the spawn {spawn_s:.1f} s "
          f"with start-up, the reduced run and the small case; peak "
          f"{max(r['peak_gb'] for r in fr):.2f} GB a rank ([train-seq], 1 × "
          f"2, full replicas: 15.52 GB, PERF.md §5); bytes = the dry run's, "
          f"the rows bit-identical, the gathered params the same on all 4 "
          f"ranks "
          f"[{card}]", flush=True)
    _print_mesh_ranks("(a)", fr, card)
    check_dry_run("(a)", fr, dry["(a)"], card)
    rr = [r["reduced"] for r in ranks]
    print(f"[mesh] launch.train's reduced {ARCH} --data 2 --ranks 2 (vocab "
          f"{tr['vocab']}, {rcfg.n_layers} layers, {DH16_HEADS[0]}/"
          f"{DH16_HEADS[1]} heads of 16), B {red['batch']} N {tr['N']} (B "
          f"{tr['B']} a data row), prism(L={tr['L']}), {MESH_STEPS} steps, "
          f"the checkpoint at step 2: segment_means "
          f"{sum(x['launches'][0] for x in rr[0]['rows'])}, prism_attention "
          f"{sum(x['launches'][1] for x in rr[0]['rows'])} launches a rank "
          f"(head width 16); loss "
          + " → ".join(f"{x:.4f}" for x in rr[0]["losses"])
          + f"; bytes = the dry run's, rows bit-identical [{card}]",
          flush=True)
    got, want = sur[0]["losses"][0], rr[0]["losses"][2]
    rel = abs(got - want) / abs(want)
    print(f"[mesh] (b) the re-mesh, on the reduced config: ranks 2, 3 "
          f"dropped, best_mesh {dict(mesh.shape)}; the 2 survivors restore "
          f"step {sur[0]['start']} (global arrays, each rank its blocks under"
          f" the new plan) and take step 3: loss {got:.6f} against "
          f"{want:.6f} uninterrupted on (2, 2), {rel:.2e} relative (≤ "
          f"{MESH_REMESH_RTOL:g}: bf16, other sum orders); "
          f"{remesh_s:.1f} s with start-up [{card}]", flush=True)
    _print_mesh_ranks("(b)", sur, card)
    if sur[0]["start"] != 2 or not rel <= MESH_REMESH_RTOL:
        raise AssertionError(f"[mesh] (b): step 3 loss {got} vs {want}")
    tr = [r["tp_reduced"] for r in ranks]
    mo = [r["tp_moe"] for r in ranks]
    print(f"[mesh] reduced {ARCH} and {MESH_MOE} --mode local --data 2 "
          f"--ranks 2 (tensor parallelism over model, the batch over data; "
          f"the moe aux loss the whole batch's): loss "
          + " → ".join(f"{x:.4f}" for x in tr[0]["losses"]) + " and "
          + " → ".join(f"{x:.4f}" for x in mo[0]["losses"])
          + f"; bytes = the dry run's (llama), the ranks holding each block "
          f"bit-identical [{card}]", flush=True)
    tf = [r["tp_full"] for r in ranks]
    print(f"[mesh] (c) {ARCH} cut to {TRAIN_SEQ_LAYERS} of 16 layers at "
          f"full width, --mode local on (2, 2): tensor parallelism over "
          f"model (16/4 heads, the MLP and the vocabulary split a rank), "
          f"the batch over data, B {MESH_B} N {LM_N}, {MESH_TP_STEPS} steps "
          f"rematerialised; peak {max(r['peak_gb'] for r in tf):.2f} GB a "
          f"rank against (a)'s {max(r['peak_gb'] for r in fr):.2f} GB; "
          f"bytes = the dry run's count [{card}]",
          flush=True)
    _print_mesh_ranks("(c)", tf, card)
    check_dry_run("(c)", tf, dry["(c)"], card)
    hy = [r["tp_hymba"] for r in ranks]
    print(f"[mesh] (f) {tp['hymba']['arch']} cut to "
          f"{tp['hymba']['layers']} of 32 layers at full width, --mode "
          f"local on (2, 2): its 25/5 heads split 15/10 by whole KV groups "
          f"(wq/wk/wv/wo moved between the JAX blocks and the head blocks "
          f"over the row), its Mamba 1600 of 3200 inner channels a rank, B "
          f"{MESH_B} N {LM_N}, {MESH_TP_STEPS} step; peak "
          f"{max(r['peak_gb'] for r in hy):.2f} GB a rank [{card}]",
          flush=True)
    _print_mesh_ranks("(f)", hy, card)
    check_dry_run("(f)", hy, dry["(f)"], card)
    xl = [r["tp_xlstm"] for r in ranks]
    print(f"[mesh] (g) {tp['xlstm']['arch']} cut to "
          f"{tp['xlstm']['layers']} of 24 layers (one of its 3 groups) at "
          f"full width, --mode local on (2, 2): 7 mLSTM blocks by value "
          f"channel (2 of its 4 heads a rank), the sLSTM by head (2 of 4), "
          f"the vocabulary split, B {MESH_XLSTM_B} N {MESH_XLSTM_N}, "
          f"{MESH_TP_STEPS} step; peak {max(r['peak_gb'] for r in xl):.2f} "
          f"GB a rank [{card}]", flush=True)
    _print_mesh_ranks("(g)", xl, card)
    check_dry_run("(g)", xl, dry["(g)"], card)
    heads_launches = {label: _check_tp_heads(label, [r["heads"][label]
                                                     for r in ranks], card)
                      for label in MESH_TP_HEADS}
    dec = [r["decode"] for r in ranks]
    one = dec[0]["one"]
    for mode in ("local", "prism"):
        for d in dec:
            if not (d[mode]["tokens"] == one["tokens"]).all():
                raise AssertionError(f"[mesh] (d) {mode}: greedy tokens "
                                     f"{d[mode]['tokens'].tolist()} vs one "
                                     f"rank's {one['tokens'].tolist()}")
            if d[mode]["launches"] == 0:
                raise AssertionError(f"[mesh] (d) {mode}: no flash-decode "
                                     f"launch")
        d = dec[0][mode]
        steady = statistics.median(d["ms"][1:])
        print(f"[mesh] (d) build_decode_step {ARCH} full width, 16 layers, "
              f"f32, B {MESH_DEC_B}, {mode}"
              + (f"(L={LM_L})" if mode == "prism" else " TP")
              + f" on (2, 2): the cache a rank {list(d['kv_heads'])}, "
              f"{d['split']} leaves split over model; {MESH_DEC_T0} prompt "
              f"steps then {MESH_DEC_NEW} greedy: tokens = one rank's "
              f"exactly; {d['launches']} flash-decode launches a rank; step "
              f"{steady:.1f} ms (median; one rank alone "
              f"{statistics.median(one['ms'][1:]):.1f} ms), received tp "
              f"{d['got'].get('tp', 0) / 1e6:.3f} MB, merge "
              f"{d['got'].get('merge', 0) / 1e6:.3f} MB in "
              f"{d['got']['calls']} calls ({d['got']['seconds'] * 1e3:.1f} ms "
              f"staged) over the run [{card}]", flush=True)
    worst = 0.0
    small = [r["small"] for r in ranks]
    for r in small:
        c, h = r["cuda"], r["cpu"]
        if min(c["launches"]) == 0 or c["digest"] != small[0]["cuda"]["digest"]:
            raise AssertionError(f"[mesh] small f32: launches "
                                 f"{c['launches']}, or the gathered params "
                                 f"differ between ranks")
        for sc, sh in zip(c["steps"], h["steps"]):
            if abs(sc["loss"] - sh["loss"]) > 1e-5 * abs(sh["loss"]):
                raise AssertionError(f"[mesh] small f32: loss {sc['loss']} "
                                     f"vs the CPU's {sh['loss']}")
            for k, w in sh["grads"].items():
                err = float(np.abs(sc["grads"][k] - w).max()
                            / max(np.abs(w).max(), 1e-30))
                worst = max(worst, err)
                if err > 1e-4:
                    raise AssertionError(f"[mesh] small f32: gradient {k} "
                                         f"{err:.2e} of its largest")
    rows = {}
    for r in small:
        rows.setdefault(r["coords"]["data"], set()).add(
            r["cuda"]["shard_digest"])
    if any(len(d) != 1 for d in rows.values()):
        raise AssertionError("[mesh] small f32: the ranks of a row differ")
    print(f"[mesh] small f32 {ARCH} (d {SMALL_LLAMA['d_model']}, "
          f"{SMALL_LLAMA['n_heads']}/{SMALL_LLAMA['n_kv_heads']} heads of "
          f"{SMALL_LLAMA['head_dim']}) on the (2, 2) mesh, prism(L="
          f"{MESH_SMALL_L}), B {MESH_SMALL_B} N {MESH_SMALL_N}, "
          f"{MESH_SMALL_STEPS} steps, card ranks vs CPU ranks: gradients "
          f"≤ {worst:.2e} of each leaf's largest (≤ 1e-4), losses ≤ 1e-5; "
          f"segment_means {small[0]['cuda']['launches'][0]}, "
          f"prism_attention {small[0]['cuda']['launches'][1]} launches a "
          f"rank; rows bit-identical, gathered params the same on all 4 "
          f"ranks [{card}]", flush=True)
    launches = dict.fromkeys(("segment_means", "prism_attention",
                              "segment_means_dh16", "prism_attention_dh16"),
                             0)
    for mode in ("local", "prism"):
        launches[f"flash_decode_tp_{mode}"] = sum(d[mode]["launches"]
                                                  for d in dec)
    launches["tp_timed"] = mesh_tp_kernels()
    launches["flash_decode_tp_heads"] = heads_launches["(f)"]
    launches["heads_timed"] = mesh_heads_kernels()
    for runs, suffix in ((fr, ""), (rr, "_dh16")):
        for r in runs:
            for row in r["rows"]:
                launches["segment_means" + suffix] += row["launches"][0]
                launches["prism_attention" + suffix] += row["launches"][1]
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --- [examples]: the port's examples on the card --------------------------

def _captured(fn, *args, **kw):
    """(``fn(*args, **kw)``, the lines it printed)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue().splitlines()


def phase_examples(card: str) -> dict:
    """``[examples]``: the four twins of the JAX package's examples
    (``repro_torch.examples``) in this process on the card at their
    reference configs, each printing its reference's lines and closing
    line; then the reduced serving launcher through the dense slot pool
    and through the paged pool (bf16), and a reduced f32 llama's greedy
    tokens on the card against the CPU (``generate`` and the paged pool,
    token-exact), so that flash-decode runs at head width 16 in both
    layouts and both types → each row's launches."""
    import numpy as np
    import torch
    from repro_torch.api import InferenceSession
    from repro_torch.configs import get_config
    from repro_torch.examples import (finetune_prism, quickstart,
                                      serve_adaptive, train_lm)
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_paged)
    from repro_torch.launch import serve as serve_launch
    from repro_torch.models import registry
    from repro_torch.serving import ServingRuntime

    def counts():
        return flash_decode.launches, flash_decode_paged.launches

    launches = dict.fromkeys(("dense_bf16", "dense_f32", "paged_bf16",
                              "paged_f32"), 0)
    serve_argv = ["--mode", "local", "--requests", "6", "--batch", "2",
                  "--tokens", "4", "--prompt-len", "8"]
    runs = (("quickstart", quickstart.main, [], "QUICKSTART OK", None),
            ("serve_adaptive", serve_adaptive.main, [], "SERVE ADAPTIVE OK",
             "dense_bf16"),
            ("train_lm", train_lm.main, [], "TRAIN LM OK", None),
            ("finetune_prism", finetune_prism.main, [], "FINETUNE PRISM OK",
             None),
            ("launch.serve", serve_launch.main, serve_argv, "SERVE OK",
             "dense_bf16"),
            ("launch.serve --pages", serve_launch.main,
             serve_argv + ["--pages", "48", "--page-size", str(DH16_PS)],
             "SERVE OK", "paged_bf16"))
    for name, fn, argv, closing, row in runs:
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, lines = _captured(fn, ["--device", "cuda", *argv])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for ln in lines:
            print(f"[examples] {name}: {ln}", flush=True)
        if closing not in lines:
            raise AssertionError(f"[examples] {name}: no {closing!r}")
        dense, paged = (a - b for a, b in zip(counts(), before))
        if row is not None:
            launches[row] += paged if row.startswith("paged") else dense
            if not (paged if row.startswith("paged") else dense):
                raise AssertionError(f"[examples] {name}: no flash-decode "
                                     f"launch at dh 16")
        print(f"[examples] {name}: {dt:.1f} s on the card; "
              f"flash_decode {dense}, flash_decode_paged {paged} launches "
              f"(head width 16) [{card}]", flush=True)
    # a reduced f32 llama on the card vs the CPU: greedy tokens exact
    reduced = {"dtype": "float32", "vocab_size": 128}
    params = registry.init_params(get_config(ARCH).reduced(**reduced),
                                  seed=0, device="cpu")
    rng = np.random.RandomState(9)
    prompt = torch.from_numpy(rng.randint(0, 128, (DH16_GEN_B, 8)))
    base = list(rng.randint(1, 128, 21))
    prompts = [base, base + [5, 6], list(rng.randint(1, 128, 11))]
    got = {}
    for dev in ("cuda", "cpu"):
        session = InferenceSession.from_config(
            ARCH, reduced=reduced, params=_on(params, dev), device=dev,
            allow_modes=("local",))
        session.profile(backend="simulated")
        before = counts()
        tokens = session.generate(prompt.to(dev), 8).cpu()
        paged = ServingRuntime(session, chunk=4, max_len=40,
                               page_size=DH16_PS, n_pages=32, n_rows=3)
        served = _serve_all(paged, prompts, 9)
        if dev == "cuda":
            d, p = (a - b for a, b in zip(counts(), before))
            launches["dense_f32"] += d
            launches["paged_f32"] += p
        got[dev] = (tokens, served)
    if not torch.equal(got["cuda"][0], got["cpu"][0]) or not all(
            np.array_equal(a, b) for a, b in zip(got["cuda"][1],
                                                 got["cpu"][1])):
        raise AssertionError("[examples] reduced f32 llama: card tokens "
                             "differ from the CPU's")
    print(f"[examples] reduced f32 llama (4/2 heads of 16) on the card vs "
          f"the CPU: generate B {DH16_GEN_B} 8 + 8 and {len(prompts)} "
          f"requests × 9 tokens through the paged pool (ps {DH16_PS}) "
          f"token-exact; flash_decode {launches['dense_f32']}, "
          f"flash_decode_paged {launches['paged_f32']} launches [{card}]",
          flush=True)
    return launches



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
        for dtype, dh, group in ((torch.bfloat16, 16, 8),
                                 (torch.float32, 16, 4),
                                 (torch.float32, 16, 8),
                                 (torch.bfloat16, 64, 8),
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
    for dtype, out_dtype, dh, dv, warps in (
            (torch.bfloat16, torch.bfloat16, 16, 16, 4),
            (torch.bfloat16, torch.float32, 16, 16, 4),
            (torch.float32, torch.float32, 16, 16, 0),
            (torch.bfloat16, torch.bfloat16, 64, 64, 7),
            (torch.bfloat16, torch.float32, 64, 64, 7),
            (torch.bfloat16, torch.bfloat16, 128, 128, 8),
            (torch.bfloat16, torch.float32, 128, 128, 8),
            (torch.bfloat16, torch.bfloat16, 192, 128, 8),
            (torch.bfloat16, torch.float32, 192, 128, 8),
            (torch.float32, torch.float32, 64, 64, 0),
            (torch.float32, torch.float32, 128, 128, 0),
            (torch.float32, torch.float32, 192, 128, 0)):
        body = (f"{warps} + 1 warps" if dtype == torch.bfloat16
                else "CUDA-core body")
        a = prism_attributes(dh, dtype, out_dtype, warps, dv=dv)
        print(f"[build] prism_attention {str(dtype).split('.')[1]} → "
              f"{str(out_dtype).split('.')[1]} dqk={dh} dv={dv} ({body}): "
              f"{_resources(a)}", flush=True)


def _resources(a: dict) -> str:
    return (f"{a['registers']} registers, {a['spill_bytes']} bytes spilled, "
            f"{a['smem_bytes']} bytes of shared memory per CTA, "
            f"{a['ctas_per_sm']} CTAs per SM")


def main(argv=None) -> None:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description="The port's chip smoke: every "
                                 "phase with no arguments.")
    ap.add_argument("--only", default="", help="a comma-separated subset "
                    "of dh16, examples, train, train-seq, train-seq-families, "
                    "mesh to run after the build, for measurements (no "
                    "kernels line)")
    ap.add_argument("--remat", default="on", choices=["on", "off", "both"],
                    help="--only's train-seq and train-seq-families with "
                    "each layer rematerialised, without, or both in turn")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a CUDA "
             "card")
    _exact_fp32()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = nvidia_smi()
    print(f"[device] {name}, {count} device(s); nvidia-smi: {card}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    start = time.perf_counter()

    def run(name, fn, *args):
        """``fn(*args)``, its seconds printed as a line of their own."""
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[time] {name} {time.perf_counter() - t0:.1f} s (run "
              f"{time.perf_counter() - start:.1f} s)", flush=True)
        return out

    run("build", phase_build)
    if args.only:
        modes = {"on": (True,), "off": (False,), "both": (True, False)}
        for phase in args.only.split(","):
            if phase in ("train-seq", "train-seq-families"):
                fn = (phase_train_seq if phase == "train-seq"
                      else phase_train_seq_families)
                for on in modes[args.remat]:
                    run(f"{phase} remat {'on' if on else 'off'}", fn, card,
                        on)
            else:
                run(phase, {"dh16": lambda _: phase_dh16_kernels(),
                            "examples": phase_examples,
                            "train": phase_train,
                            "mesh": phase_mesh}[phase], card)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": count}}))
        return
    timed = run("kernels", phase_kernels)
    shard = run("shard partial", phase_shard_partial)
    gemma_shard = run("gemma shard partial", phase_gemma_shard_partial)
    paged = run("paged kernel", phase_paged_kernel)
    exchange = run("exchange kernels", phase_exchange_kernels)
    xk = run("xattn kernels", phase_xattn_kernels)
    sk = run("ssm kernels", phase_ssm_kernels)
    dk = run("dh16 kernels", phase_dh16_kernels)
    run("reference", phase_small_reference)
    run("reference serving", phase_small_serving)
    run("reference vit", phase_small_vit_reference)
    run("reference lm", phase_small_lm_reference)
    run("reference gemma", phase_small_gemma_reference)
    run("reference moe", phase_small_moe_reference)
    run("reference xattn", phase_small_xattn_reference)
    run("reference ssm", phase_small_ssm_reference)
    ex = run("examples", phase_examples, card)
    launches, session = run("session", phase_session, card)
    serve_dense, serve_paged = run("serve", phase_serve, card, session)
    del session
    torch.cuda.empty_cache()
    vit_launches = run("vit", phase_vit, card)
    lm_launches = run("lm", phase_lm, card)
    lm_launches["flash_decode"] += run("codec", phase_codec, card)
    gemma_launches = run("gemma", phase_gemma, card)
    run("profile-seq", phase_profile_seq, card)
    fleet_launches = run("fleet", phase_fleet, card)
    archs = {arch: run(f"arch {arch}", phase_arch_session, card, arch)
             for arch, _, _ in DECODE_ARCHS}
    archs[MLA_ARCH] = run(f"arch {MLA_ARCH}", phase_arch_session, card,
                          MLA_ARCH)
    moe = run("moe-seq", phase_moe_seq, card)
    xa = {arch: run(f"arch {arch}", phase_xattn_arch, card, arch)
          for arch in XATTN_ARCHS}
    xs = run("xattn-seq", phase_xattn_seq, card)
    sa = {arch: run(f"arch {arch}", phase_ssm_arch, card, arch)
          for arch in SSM_ARCHS}
    ss = run("ssm-seq", phase_ssm_seq, card)
    tk = run("train-kernels", phase_train_kernels, card)
    run("train-reference", phase_train_reference, card)
    run("train", phase_train, card)
    ts = run("train-seq", phase_train_seq, card)
    run("train-families", phase_train_families, card)
    tsf = run("train-seq-families", phase_train_seq_families, card)
    ms = run("mesh", phase_mesh, card)

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
    mnp = LM_N // LM_P
    for kname, n, t, shape in (
            ("segment_means", moe["segment_means_moe"],
             exchange["segment_means_moe"],
             f"{MOE} prism forward per rank ({LM_P} ranks): K and V bf16 "
             f"[{LM_B}, {mnp}, 16·128] L={LM_L}"),
            ("prism_attention", moe["prism_attention_moe"],
             exchange["prism_attention_moe"],
             f"{MOE} prism forward per rank: bf16 [{LM_B}, {mnp}] 16/16 "
             f"heads dh=128 causal L={LM_L} part 1"),
            ("segment_means", moe["segment_means_mla"],
             exchange["segment_means_mla"],
             f"{MLA_ARCH} prism forward per rank: the latent bf16 [{LM_B}, "
             f"{mnp}, 512 + 64] L={LM_L}, one input"),
            ("prism_attention", moe["prism_attention_mla"],
             exchange["prism_attention_mla"],
             f"{MLA_ARCH} prism forward per rank: bf16 [{LM_B}, {mnp}] "
             f"128/128 heads, keys 192 (128 + 64), values 128, causal "
             f"L={LM_L} part 1 (the (192, 128) instantiation)")):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": src.format(kname, kname),
            "replaces": {r[0]: r[1] for r in rows}[kname], "launches": n,
            "shape": shape, **{k: t[k] for k in keys}})
    kernels += xattn_kernel_rows(xa, xk, xs,
                                 {r[0]: r[1] for r in rows}, keys)
    kernels += ssm_kernel_rows(sa, sk, ss, {r[0]: r[1] for r in rows}, keys)
    for kname, t in (("segment_means", exchange["segment_means_lm"]),
                     ("prism_attention", exchange["prism_attention_lm"])):
        b = tk[(kname, "llama")]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": src.format(kname, kname),
            "replaces": {r[0]: r[1] for r in rows}[kname],
            "launches": ts[kname],
            "shape": f"{ARCH} prism train step per rank ({LM_P} ranks, "
                     f"{TRAIN_SEQ_LAYERS} of 16 layers): the forward's "
                     f"kernel at the lm phase's prism shape, its explicit "
                     f"PyTorch backward timed beside it",
            **{k: t[k] for k in keys},
            "backward_ms": b["bwd_ms"], "backward_bound_ms": b["bwd_bound_ms"],
            "plain_fwd_bwd_ms": b["plain_ms"],
            "library_fwd_bwd_ms": b["library_ms"]})
    kernels += train_family_kernel_rows(tsf, exchange, sk,
                                        {r[0]: r[1] for r in rows}, keys)
    for kname, t in (("segment_means", exchange["segment_means_lm"]),
                     ("prism_attention", exchange["prism_attention_lm"])):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": src.format(kname, kname),
            "replaces": {r[0]: r[1] for r in rows}[kname],
            "launches": ms[kname],
            "shape": f"{ARCH} prism train step per rank on [mesh]'s (2, 2) "
                     f"mesh ({TRAIN_SEQ_LAYERS} of 16 layers, B {LM_B} a data"
                     f" row): the lm phase's prism shape",
            **{k: t[k] for k in keys}})
    kernels += dh16_kernel_rows(dk, ex, ms, {r[0]: r[1] for r in rows},
                                keys)
    S_tp, b_tp = MESH_DEC_T0 + MESH_DEC_NEW, MESH_DEC_B // MESH_SHAPE[0]
    for mode, shape in (
            ("local", f"{ARCH} local TP decode step per rank on [mesh]'s (2, "
                      f"2) mesh (build_decode_step, full width, 16 layers): "
                      f"f32 B={b_tp} S={S_tp} {N_HEADS // 2}/{N_KV // 2} "
                      f"heads dh=64 (G 4), the last greedy step's lengths"),
            ("prism", f"{ARCH} prism(L={LM_L}) decode step per rank on "
                      f"[mesh]'s (2, 2) mesh, the MLP split over model: "
                      f"shard partial f32 B={b_tp} Sp={S_tp // 2} of "
                      f"S={S_tp}, rank 1, {N_HEADS}/{N_KV} heads dh=64")):
        kernels.append({
            "name": "flash_decode", "route": "cuda",
            "source": src.format("flash_decode", "flash_decode"),
            "replaces": rows[0][1], "launches": ms[f"flash_decode_tp_{mode}"],
            "shape": shape, **{k: ms["tp_timed"][mode][k] for k in keys}})
    for m, t in ms["heads_timed"].items():
        kernels.append({
            "name": "flash_decode", "route": "cuda",
            "source": src.format("flash_decode", "flash_decode"),
            "replaces": rows[0][1],
            "launches": ms["flash_decode_tp_heads"][m],
            "shape": f"{MESH_TP_HEADS['(f)'][0]} local TP decode step on "
                     f"[mesh]'s (2, 2) mesh, model rank {m} (build_decode_"
                     f"step, full width, {MESH_TP_HEADS['(f)'][1]} layers): "
                     f"f32 B={b_tp} S={MESH_DEC_T0 + MESH_TP_NEW} "
                     f"{t['heads'][0]}/{t['heads'][1]} heads dh=64 (G 5), "
                     f"the last greedy step's lengths",
            **{k: t[k] for k in keys}})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


if __name__ == "__main__":
    main()
