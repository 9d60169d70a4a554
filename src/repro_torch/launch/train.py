"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train [--arch llama3.2-1b] \
        [--steps 50] [--mode prism|voltage|local] [--ranks 2] [--batch 8] \
        [--seq 128] [--L 4] [--full] [--device cuda|cpu] [--ckpt-dir DIR]

The counterpart of ``repro.launch.train``.  In place of its debug mesh
(``--devices``) it takes ``--ranks P``: P processes started by
``repro_torch.core.seq_group.spawn``, a seq group over gloo, all on the
one card (or the CPU).  Every rank holds a replica of the params and
optimizer state, trains its part of the sequence of every batch under
``--mode voltage`` or ``prism`` (the exchanges' collectives carry the
gradient back across the ranks; under ``prism`` the segment means and
PRISM attention run on their kernels), and the ranks sum their gradients
in one staged ``all_reduce``, so the replicas stay identical; the launcher
checks that they end bit-identical.  The JAX launcher's data axis has no
counterpart: one batch, P sequence parts.  ``--mode local`` trains one
process (``--ranks 1``).

``--arch`` takes every causal LM of the JAX launcher, and what each needs
of ``--ranks`` P: P divides ``--seq`` (and, under ``prism``, each part
splits into ``--L`` segments); beyond that

* the dense LMs, the moe family (routed as the whole sequence: one
  routing call a layer) and deepseek-v2's MLA (the latent exchanged):
  any P ≥ 2;
* gemma2-27b: its windowed layers exchange only their halo under
  ``prism`` where the window spans fewer than P − 1 parts, so at P ≥ 3
  (the reduced config's window 16 at the default ``--seq 128`` and
  ``--ranks 4``: parts of 32, one halo shift a windowed layer); at P 2,
  or a wider window, they take the Voltage gather, as in the JAX package;
* whisper-large-v3 and llama-3.2-vision-11b: any P ≥ 2, the memory (the
  encoded frames, the image tokens, drawn from the batch's seed:
  ``encoder_seq`` or ``image_tokens`` embeddings) split like the text;
* hymba-1.5b and xlstm-350m: any P ≥ 2, each mixer's state handed from
  rank to rank (one ``state`` message a mixer and its cotangent back).

Rank 0 prints each logged step's halo and state calls, so a run shows
which path ran.

The model is the reduced config of ``--arch`` (vocabulary 512, as the JAX
launcher's ``--reduced``) unless ``--full`` asks for the published widths
(random weights from seed 0, bf16 params, f32 AdamW moments).  Batches
come from the synthetic Markov stream, batch ``step`` drawn from
``RandomState(1000 + step)`` as the JAX launcher draws it.  Every 50
steps rank 0 saves (params, optimizer state) asynchronously under
``--ckpt-dir``.  It prints the JAX launcher's lines (each step's time
beside the card's name and power limit), then ``TRAIN OK``.
"""
import argparse
import hashlib
import os
import subprocess
import tempfile
import time

import numpy as np

CKPT_EVERY = 50
LM_ARCHS = ("llama3.2-1b", "internlm2-1.8b", "qwen1.5-32b", "gemma2-27b",
            "deepseek-moe-16b", "deepseek-v2-236b", "whisper-large-v3",
            "llama-3.2-vision-11b", "hymba-1.5b", "xlstm-350m")
RANK_TIMEOUT_S = 3000.0        # the ranks' whole run (full width: minutes)


def card_name(device: str) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (the
    CPU's label when training there)."""
    if device == "cpu":
        return "the CPU (no card)"
    import torch
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out = f"{torch.cuda.get_device_name(0)}, power limit not read"
    return out


def _digest(tree) -> str:
    """SHA-1 over the bytes of every leaf, in tree order."""
    import torch
    from repro_torch.utils.tree import tree_leaves
    h = hashlib.sha1()
    for t in tree_leaves(tree):
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def draw_batch(ds, cfg, step: int) -> dict:
    """Batch ``step``: the Markov stream's tokens and labels from
    ``RandomState(1000 + step)``, then, for the memory families, the stub
    memory (whisper's frames ``[B, encoder_seq, d]``, the vlm's image
    embeddings ``[B, image_tokens, d]``, f32) from the same stream."""
    rng = np.random.RandomState(1000 + step)
    b = ds.sample(rng)
    if cfg.family in ("audio", "vlm"):
        name, m = (("frames", cfg.encoder_seq) if cfg.family == "audio"
                   else ("image_embeds", cfg.image_tokens))
        b[name] = rng.randn(ds.batch_size, m, cfg.d_model).astype(np.float32)
    return b


def train(a: dict, rank: int = 0, world: int = 1) -> dict:
    """Train ``a["steps"]`` steps on this rank → its losses, step times,
    staged seconds and bytes, and the digest of its final params."""
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.exchange import (ExchangeConfig, ExchangeMode,
                                           seq_group_for)
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.models import registry
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import build_train_step

    device = a["device"]
    cfg = get_config(a["arch"])
    if not a["full"]:
        cfg = cfg.reduced(vocab_size=512)
    mode = ExchangeMode(a["mode"])
    xcfg = (ExchangeConfig() if mode == ExchangeMode.LOCAL else
            ExchangeConfig(mode, seq_axis="seq", seq_shards=world, L=a["L"]))
    group = seq_group_for(xcfg) if world > 1 else None
    params = registry.init_params(cfg, seed=0, device=device)
    opt = adamw_init(params)
    step_fn = build_train_step(cfg, xcfg)
    ds = SyntheticLMDataset(cfg.vocab_size, a["seq"], a["batch"])
    ckpt = CheckpointManager(a["ckpt_dir"], keep=2) if rank == 0 else None
    card = card_name(device) if rank == 0 else ""
    losses, ms, staged = [], [], []
    for step in range(a["steps"]):
        batch = {k: torch.from_numpy(v).to(device) for k, v in
                 draw_batch(ds, cfg, step).items()}
        if group is not None:
            group.reset_stats()
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        if device == "cuda":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        staged.append(0.0 if group is None else group.stats.seconds * 1e3)
        losses.append(float(m["loss"]))
        if rank == 0 and (step % 10 == 0 or step == a["steps"] - 1):
            st = group.stats if group is not None else None
            print(f"step {step:4d} loss {losses[-1]:.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} ({ms[-1]:.1f} ms"
                  + (f", {staged[-1]:.1f} ms staged, {st.halo_calls} halo "
                     f"calls, {st.state_calls} state calls" if st else "")
                  + f"; {card})", flush=True)
        if ckpt is not None and (step + 1) % CKPT_EVERY == 0:
            ckpt.save_async((params, opt), step + 1)
    if ckpt is not None:
        ckpt.wait()
    st = group.stats if group is not None else None
    return dict(losses=losses, ms=ms, staged_ms=staged, card=card,
                grad_bytes=0 if st is None else st.grad_bytes,
                digest=_digest(params))


def train_rank(rank: int, world: int, a: dict) -> dict:
    """One rank of ``--ranks P`` (started by ``seq_group.spawn``)."""
    return train(a, rank, world)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=LM_ARCHS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--mode", default="prism",
                    choices=["prism", "voltage", "local"])
    ap.add_argument("--ranks", type=int, default=2,
                    help="sequence-partition ranks (1 under --mode local)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--L", type=int, default=4)
    ap.add_argument("--full", action="store_true",
                    help="the published widths instead of the reduced "
                         "config (random weights from seed 0)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda needs a CUDA card; pass "
                             "--device cpu to train on the CPU")
    ranks = 1 if args.mode == "local" else args.ranks
    if args.mode == "local" and args.ranks > 1:
        print(f"--mode local trains one process: --ranks {args.ranks} "
              f"ignored", flush=True)
    if args.mode != "local" and ranks < 2:
        raise SystemExit(f"--mode {args.mode} partitions the sequence: "
                         f"give --ranks 2 or more")
    a = dict(vars(args))
    if ranks == 1:
        results = [train(a)]
    else:
        from repro_torch.core.seq_group import spawn
        results = spawn(train_rank, ranks, a, timeout=RANK_TIMEOUT_S)
    r0 = results[0]
    same = all(r["digest"] == r0["digest"] for r in results)
    tokens = args.batch * args.seq
    steady = r0["ms"][1:] or r0["ms"]
    mean_ms = float(np.mean(steady))
    print(f"done: loss {np.mean(r0['losses'][:5]):.3f} → "
          f"{np.mean(r0['losses'][-5:]):.3f} on {ranks} rank(s) "
          f"mode={args.mode}", flush=True)
    print(f"timing: {mean_ms:.1f} ms a step after the first "
          f"({tokens / mean_ms * 1e3:.0f} tokens/s"
          + (f", {np.mean(r0['staged_ms'][1:] or r0['staged_ms']):.1f} ms "
             f"staged, grad bytes {r0['grad_bytes']} in the last step"
             if ranks > 1 else "") + f"; {r0['card']})", flush=True)
    if ranks > 1:
        print(f"replicas: {'bit-identical' if same else 'DIFFER'} after "
              f"{args.steps} steps", flush=True)
    if not same or not np.isfinite(r0["losses"]).all():
        raise SystemExit("training failed: "
                         + ("the replicas differ" if not same
                            else "a loss is not finite"))
    print("TRAIN OK", flush=True)


if __name__ == "__main__":
    main()
