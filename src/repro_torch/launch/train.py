"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train [--arch llama3.2-1b] \
        [--steps 50] [--mode prism|voltage|local] [--ranks 2] [--data D] \
        [--batch 8] [--seq 128] [--L 4] [--full] [--layers N] \
        [--device cuda|cpu] [--ckpt-dir DIR] [--ckpt-every 50] [--resume]

The counterpart of ``repro.launch.train``.  Without ``--data`` it takes
``--ranks P``: P processes started by ``repro_torch.core.seq_group.spawn``,
a seq group over gloo, all on the one card (or the CPU).  Every rank holds
a replica of the params and optimizer state, trains its part of the
sequence of every batch under ``--mode voltage`` or ``prism`` (the
exchanges' collectives carry the gradient back across the ranks; under
``prism`` the segment means and PRISM attention run on their kernels), and
the ranks sum their gradients in one staged ``all_reduce``, so the
replicas stay identical; the launcher checks that they end bit-identical.
``--mode local`` trains one process (``--ranks 1``).

``--data D`` trains on the JAX launcher's ``("data", "model")`` mesh of D ×
P ranks (``launch.mesh.make_auto_mesh``, ``seq_group.spawn_mesh``),
planned by ``sharding.specs.make_plan(..., train=True)``: each row of P
ranks is a seq group over ``model`` as above, the global batch splits over
``data``, the params are ZeRO-3 blocks over ``data`` (each layer gathered
as the model reaches it and again in its recompute, its gradient
reduce-scattered as the backward leaves it; booked as ``param`` and
``grad``), the optimizer state ZeRO-1 blocks
over both axes, leaf by leaf as the JAX plan says
(``sharding.placement``).  ``--mode local --data D --ranks 1`` is
data-parallel ZeRO training; ``--mode local --data D --ranks M`` (or
``--mode local --ranks M`` alone: D = 1) adds tensor parallelism over the
model axis, as the JAX launcher's ``(devices // 2, 2)`` mesh does
(``models.tp``: each rank its heads, MLP columns, experts and vocabulary
rows where M divides them; the other leaves gathered whole over the row).
The check: every two ranks that hold the same block of a leaf hold the
same bits (without tensor parallelism: the ranks of a row), and the
params gathered whole are the same on every rank.
Checkpoints hold the
global arrays in the JAX layout; ``--resume`` restores the newest one in
``--ckpt-dir`` into the current mesh (each rank its blocks under the new
plan) and trains on from its step — how a run re-meshed after losing
ranks continues (``runtime.elastic``).

``--arch`` takes every causal LM of the JAX launcher, and what each needs
of ``--ranks`` P: P divides ``--seq`` (and, under ``prism``, each part
splits into ``--L`` segments); beyond that

* the dense LMs, the moe family (routed as the whole sequence: one
  routing call a layer) and deepseek-v2's MLA (the latent exchanged):
  any P ≥ 2 (the moe family on one data row: its aux loss is the whole
  batch's);
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
(random weights from seed 0, bf16 params, f32 AdamW moments);
``--layers N`` cuts its depth.  Batches come from the synthetic Markov
stream, batch ``step`` drawn from ``RandomState(1000 + step)`` as the JAX
launcher draws it.  Every ``--ckpt-every`` (50) steps rank 0 saves (params,
optimizer state) asynchronously under ``--ckpt-dir``.  It prints the JAX
launcher's lines (each step's time beside the card's name and power
limit), then ``TRAIN OK``.
"""
import argparse
import hashlib
import os
import subprocess
import tempfile
import time

import numpy as np

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
    from repro_torch.core.exchange import (ExchangeConfig, ExchangeMode,
                                           seq_group_for)
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.models import registry
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import build_train_step

    device = a["device"]
    cfg = model_config(a)
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
        if ckpt is not None and (step + 1) % a["ckpt_every"] == 0:
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


def model_config(a: dict):
    """``--arch``'s config: reduced (vocabulary 512) unless ``--full``,
    cut to ``--layers`` if given."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(a["arch"])
    if not a["full"]:
        cfg = cfg.reduced(vocab_size=512)
    if a.get("layers"):
        cfg = dataclasses.replace(cfg, n_layers=a["layers"])
    return cfg


def _received(groups) -> dict:
    """Bytes received by kind over the mesh's groups, and their calls and
    staged seconds."""
    out = dict(calls=0, seconds=0.0)
    for g in groups:
        for f, v in vars(g.stats).items():
            if f.endswith("_bytes"):
                out[f[:-6]] = out.get(f[:-6], 0) + v
        out["calls"] += g.stats.calls
        out["seconds"] += g.stats.seconds
    return out


def train_mesh(rank: int, world: int, a: dict) -> dict:
    """One rank of ``--data D --ranks P`` (``seq_group.spawn_mesh`` starts
    it and joins it to the mesh): train ``a["steps"]`` steps → its losses,
    step times, staged seconds, bytes received by kind a step, kernel
    launches, peak memory on the card, and the digests of its shards and
    of the params gathered whole."""
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.exchange import ExchangeMode
    from repro_torch.core.seq_group import get_seq_group
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.kernels.prism_attention import prism_attention
    from repro_torch.kernels.segment_means import segment_means
    from repro_torch.launch.mesh import get_abstract_mesh
    from repro_torch.models import registry
    from repro_torch.sharding.placement import Placement
    from repro_torch.sharding.specs import make_plan
    from repro_torch.train.train_step import build_train_step

    device = a["device"]
    cfg = model_config(a)
    mesh = get_abstract_mesh()
    plan = make_plan(mesh, cfg, ExchangeMode(a["mode"]), L=a["L"],
                     train=True)
    place = Placement(plan, cfg, registry.abstract_params(cfg))
    groups = [get_seq_group(axis) for axis in mesh.axis_names]
    ckpt = CheckpointManager(a["ckpt_dir"], keep=2)
    start = 0
    tp = "" if place.tp is None else (
        f", tensor parallelism over model ({len(place.tp_dim)} of "
        f"{len(place.keys)} leaves split"
        + (f", {len(place.moved)} of them moved to their head blocks over "
           f"the row" if place.moved else "")
        + ", the others gathered whole)")
    if a["resume"]:
        start = ckpt.latest
        if start is None:
            raise SystemExit(f"--resume: no checkpoint under "
                             f"{a['ckpt_dir']}")
        template, places = place.state_template()
        blocks, opt = ckpt.restore(template, start, device=device,
                                   placements=places)
    else:
        blocks, opt = place.init_state(
            registry.init_params(cfg, seed=0, device=device))
    step_fn = build_train_step(cfg, plan.xcfg, placement=place)
    ds = SyntheticLMDataset(cfg.vocab_size, a["seq"], a["batch"])
    card = card_name(device) if rank == 0 else ""
    if rank == 0:
        print(f"mesh {dict(mesh.shape)} ({world} ranks), mode={a['mode']}: "
              f"params ZeRO-3 over data, optimizer state ZeRO-1 over "
              f"{mesh.axis_names}{tp}"
              + (f", resumed at step {start}" if a["resume"] else ""),
              flush=True)
    losses, ms, staged, rows = [], [], [], []
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for step in range(start, a["steps"]):
        batch = {k: torch.from_numpy(v).to(device) for k, v in
                 draw_batch(ds, cfg, step).items()}
        for g in groups:
            g.reset_stats()
        before = (segment_means.launches, prism_attention.launches)
        t0 = time.perf_counter()
        blocks, opt, m = step_fn(blocks, opt, batch)
        if device == "cuda":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        got = _received(groups)
        got["launches"] = (segment_means.launches - before[0],
                           prism_attention.launches - before[1])
        rows.append(got)
        staged.append(got["seconds"] * 1e3)
        losses.append(float(m["loss"]))
        if rank == 0 and (step % 10 == 0 or step == a["steps"] - 1):
            print(f"step {step:4d} loss {losses[-1]:.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} ({ms[-1]:.1f} ms, "
                  f"{staged[-1]:.1f} ms staged; {card})", flush=True)
        if (step + 1) % a["ckpt_every"] == 0:
            place.save(ckpt if rank == 0 else None, blocks, opt, step + 1)
    ckpt.wait()
    peak = (torch.cuda.max_memory_allocated() / 1e9 if device == "cuda"
            else 0.0)
    return dict(losses=losses, ms=ms, staged_ms=staged, rows=rows,
                card=card, coords=place.coords, peak_gb=peak,
                grad_bytes=rows[-1]["grad"] if rows else 0,
                blocks={k: (str(place.index(k, place.spec[k])),
                            _digest([blocks[k]])) for k in place.keys},
                digest=_digest(place.whole(blocks, place.spec)),
                tp=place.tp is not None, start=start)


def check_mesh(results: list) -> str:
    """'' when every two ranks that hold the same block of a leaf hold the
    same bits (without tensor parallelism: the ranks of a row) and every
    rank's params gathered whole are the same; else what differs."""
    held = {}
    for r in results:
        for k, (where, digest) in r["blocks"].items():
            held.setdefault((k, where), set()).add(digest)
    bad = sorted(k for (k, _), d in held.items() if len(d) != 1)
    if bad:
        return f"ranks holding the same block differ ({bad[0]})"
    if len({r["digest"] for r in results}) != 1:
        return "the params gathered whole differ between ranks"
    return ""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=LM_ARCHS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--mode", default="prism",
                    choices=["prism", "voltage", "local"])
    ap.add_argument("--ranks", type=int, default=2,
                    help="the model axis: sequence-partition ranks, or "
                         "under --mode local tensor-parallel ranks")
    ap.add_argument("--data", type=int, default=None,
                    help="the data axis: train on a (data, ranks) mesh "
                         "(without it: one seq group, full replicas)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--L", type=int, default=4)
    ap.add_argument("--full", action="store_true",
                    help="the published widths instead of the reduced "
                         "config (random weights from seed 0)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest checkpoint in --ckpt-dir into "
                         "this mesh and train on from its step")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda needs a CUDA card; pass "
                             "--device cpu to train on the CPU")
    a = dict(vars(args))
    if args.data is not None or args.resume or (args.mode == "local"
                                                and args.ranks > 1):
        return _main_mesh(args, a)
    ranks = 1 if args.mode == "local" else args.ranks
    if args.mode != "local" and ranks < 2:
        raise SystemExit(f"--mode {args.mode} partitions the sequence: "
                         f"give --ranks 2 or more")
    if ranks == 1:
        results = [train(a)]
    else:
        from repro_torch.core.seq_group import spawn
        results = spawn(train_rank, ranks, a, timeout=RANK_TIMEOUT_S)
    r0 = results[0]
    same = all(r["digest"] == r0["digest"] for r in results)
    _print_done(args, r0, f"on {ranks} rank(s)", ranks > 1)
    if ranks > 1:
        print(f"replicas: {'bit-identical' if same else 'DIFFER'} after "
              f"{args.steps} steps", flush=True)
    if not same or not np.isfinite(r0["losses"]).all():
        raise SystemExit("training failed: "
                         + ("the replicas differ" if not same
                            else "a loss is not finite"))
    print("TRAIN OK", flush=True)


def _print_done(args, r0, where: str, staged: bool) -> None:
    tokens = args.batch * args.seq
    steady = r0["ms"][1:] or r0["ms"]
    mean_ms = float(np.mean(steady))
    print(f"done: loss {np.mean(r0['losses'][:5]):.3f} → "
          f"{np.mean(r0['losses'][-5:]):.3f} {where} mode={args.mode}",
          flush=True)
    print(f"timing: {mean_ms:.1f} ms a step after the first "
          f"({tokens / mean_ms * 1e3:.0f} tokens/s"
          + (f", {np.mean(r0['staged_ms'][1:] or r0['staged_ms']):.1f} ms "
             f"staged, grad bytes {r0['grad_bytes']} in the last step"
             if staged else "") + f"; {r0['card']})",
          flush=True)


def _main_mesh(args, a: dict) -> None:
    """``--data D``: train on the (D, ``--ranks``) mesh."""
    data = args.data or 1
    from repro_torch.core.seq_group import spawn_mesh
    shape = (data, args.ranks)
    results = spawn_mesh(train_mesh, shape, ("data", "model"), a,
                         timeout=RANK_TIMEOUT_S)
    r0 = results[0]
    if not r0["losses"]:
        raise SystemExit(f"nothing to train: the checkpoint is at step "
                         f"{r0['start']} of --steps {args.steps}")
    _print_done(args, r0, f"on mesh {dict(data=data, model=args.ranks)}",
                True)
    bad = check_mesh(results)
    same = ("the ranks holding each block bit-identical (tensor "
            "parallelism over the rows)" if r0["tp"]
            else "the rows bit-identical")
    print(f"mesh replicas: {bad or same + ', the gathered params the same '
                                        'on every rank'} after "
          f"step {r0['start'] + len(r0['losses'])}", flush=True)
    if bad or not np.isfinite(r0["losses"]).all():
        raise SystemExit("training failed: "
                         + (bad or "a loss is not finite"))
    print("TRAIN OK", flush=True)


if __name__ == "__main__":
    main()
