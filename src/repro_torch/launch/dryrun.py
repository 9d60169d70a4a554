"""Dry run: trace every (arch × shape × mesh) cell's step for one rank of the
production mesh, on the meta device.  The port's counterpart of
``repro.launch.dryrun``.

For each cell this proves that the sharding plan is coherent on the
production mesh (16 × 16 single-pod, 2 × 16 × 16 multi-pod) and counts
what the port's eager program would do on one rank:

* the rank joins the mesh abstractly (``launch.mesh.join_abstract``: one
  ``AbstractSeqGroup`` a line, no process group) at its coordinates;
* its state is built on meta: the param blocks and the moments of the
  plan (train), or the param blocks (a plan with ``fsdp``) or the params
  the model runs on, and the rank's block of the decode cache (prefill,
  decode), and the global batch;
* the rank's real step runs once under ``launch.hlo_analysis.StepCounter``
  (the mesh train step, ``serving.engine.build_prefill_step`` or
  ``build_decode_step`` with the plan; the kernels take their meta shape
  functions, ``kernels.meta``);
* the record gives the rank's memory (arguments, the step's peak of live
  device bytes, whether it fits the H100's 80 GB), the FLOPs, HBM bytes
  and collectives by kind, the roofline terms on the H100
  (``hlo_analysis.analysis_dict``) and the rank's ``GatherStats``.

Nothing is allocated and no process group exists, so every cell runs at
full width on the CPU.  The numbers are counts of the port's program on
meta, set against the H100's 80 GB, not measurements.  The rank's peak is
the port's, not the JAX plan's: the port gathers each ZeRO-3 layer as the
model reaches it (``Placement.layer_view``: the rank's blocks plus one
layer whole, the gathered layer freed as it ends, which the counter
sees), gathers whole the few leaves the JAX plan splits over ``model``
that its TP holds whole (norm scales, the router, qkv biases, a shared
KV head, the moe shared expert, the sLSTM where M does not divide its
heads and its FFN, a latent or head count M does not divide), and under
``local`` TP takes the train loss over the rank's vocabulary columns;
without TP the loss reads f32 ``[B, N, V]`` logits of the rank's tokens
(ROADMAP [12.5]).  Under ``local`` TP the rank's decode cache holds its
heads and its recurrent mixers' channels (``engine.init_cache``).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch xlstm-350m,hymba-1.5b
      [--shape train_4k] [--both-meshes] [--jobs 4]   (every shape of each)
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
      [--mode prism] [--jobs 4]
Artifacts: artifacts/dryrun_torch/<mesh>/<arch>__<shape>__<mode>.json
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES_BY_NAME, get_config,
                                 shapes_for)
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.exchange import ExchangeConfig, ExchangeMode
from repro_torch.launch.hlo_analysis import (StepCounter, analysis_dict,
                                             storage_bytes)
from repro_torch.launch.mesh import (Mesh, join_abstract, leave_mesh,
                                     make_production_mesh, mesh_coords,
                                     mesh_groups)
from repro_torch.sharding.specs import _param_gb, axis_size

DEFAULT_L = 16
OUT_DIR = "artifacts/dryrun_torch"
META = torch.device("meta")


def default_mode(cfg: ModelConfig, shape_kind: str = "prefill"
                 ) -> ExchangeMode:
    """The adaptive policy's static projection onto the baseline table
    (the JAX package's): xLSTM has no attention → LOCAL; inference →
    PRISM; training PRISM while the weights are replicable, LOCAL (TP ×
    FSDP) above 20 GB of params."""
    if cfg.family == "ssm":
        return ExchangeMode.LOCAL
    if shape_kind == "train" and _param_gb(cfg) > 20:
        return ExchangeMode.LOCAL
    return ExchangeMode.PRISM


def model_flops(cfg: ModelConfig, shape: ShapeSpec, n_params: int) -> float:
    """Analytic MODEL_FLOPS: 6·N_active·D (train) / 2·N_active·D (fwd)."""
    active = active_params(cfg, n_params)
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind in ("train", "prefill") else shape.global_batch)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * active * tokens


def active_params(cfg: ModelConfig, n_params: int) -> float:
    if not cfg.moe:
        return float(n_params)
    m = cfg.moe
    inactive = (3 * cfg.d_model * m.d_ff_expert * (m.n_experts - m.top_k)
                * (cfg.n_layers - m.first_dense_layers))
    return float(n_params) - inactive


def grad_accum_for(cfg: ModelConfig) -> int:
    """The JAX dry run's microbatching: 16 above 100 GB of params, 4 above
    20 GB, else 1."""
    gb = _param_gb(cfg)
    if gb > 100:
        return 16
    if gb > 20:
        return 4
    return 1


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _batch(cfg: ModelConfig, kind: str, B: int, N: int) -> Dict:
    """The global batch of a (kind, B, N) step on meta."""
    from repro_torch.models import registry
    spec = ShapeSpec("dry", N, B, kind)
    return {k: _meta(s.shape, s.dtype)
            for k, s in registry.input_specs(cfg, spec).items()}


def _memory_cache(cfg: ModelConfig, cache: Dict, rows: int, xcfg) -> Dict:
    """A decode cache's memory slots as ``prefill_memory`` leaves them on
    a rank: ``mem_kv`` the rank's block of the padded memory, ``mem_mask``
    the whole memory's."""
    from repro_torch.models import registry
    from repro_torch.core.exchange import partitioned
    full = registry.abstract_cache(cfg, ShapeSpec("dry", 1, rows, "decode"),
                                   xcfg)
    kv = full["mem_kv"]["k"].shape
    P = xcfg.seq_shards if partitioned(xcfg) else 1
    hk = next(h["k"].shape[-2] for h in cache.values()
              if isinstance(h, dict) and "k" in h)   # the rank's KV heads
    block = (kv[0], kv[1], kv[2] // P, hk, kv[4])
    return {**cache,
            "mem_kv": {"k": _meta(block, cfg.torch_dtype),
                       "v": _meta(block, cfg.torch_dtype)},
            "mem_mask": _meta(full["mem_mask"].shape, torch.bool)}


def _gather_stats(groups) -> Dict:
    """The groups' ``GatherStats`` summed by field, and by axis."""
    out: Dict = {"by_axis": {}}
    for g in groups:
        row = {f: v for f, v in vars(g.stats).items() if f != "seconds"}
        out["by_axis"][g.axis] = row
        for f, v in row.items():
            out[f] = out.get(f, 0) + v
    return out


def train_state(plan, cfg: ModelConfig, aparams,
                moment_dtype=torch.float32):
    """(``Placement``, param-spec blocks, AdamW state of optimizer-spec
    blocks in ``moment_dtype``) of the rank whose mesh this process joined
    (``join_abstract``), on meta."""
    from repro_torch.sharding.placement import Placement
    place = Placement(plan, cfg, aparams)
    blocks, opt = place.init_state(aparams, moment_dtype)
    return place, blocks, opt


def trace_step(cfg: ModelConfig, kind: str, mesh: Optional[Mesh], *,
               mode: ExchangeMode, B: int, N: int, L: int = DEFAULT_L,
               coords: Optional[Dict[str, int]] = None, grad_accum: int = 1,
               acc_dtype=torch.float32, moment_dtype=torch.float32) -> Dict:
    """One rank's step of ``kind`` (train, prefill or decode) for ``cfg``
    at global batch ``B`` and sequence ``N``, traced on meta → its counts.

    ``mesh`` None: the one-process step (``build_train_step`` with
    ``ExchangeConfig(mode)``, the step builders without a plan).  Else the
    rank at ``coords`` (default rank 0's) of ``mesh`` under
    ``make_plan(mesh, cfg, mode, L)``: the mesh train step (param blocks,
    moments in ``moment_dtype`` as the plan shards them,
    ``grad_accum`` microbatches with an ``acc_dtype`` accumulator) or
    the step builders with the plan (the params the model runs on, the
    rank's block of the cache from ``engine.init_cache``; the param blocks
    under a plan with ``fsdp``).  A decode
    writes at position N − 1: the cache full, every slot read."""
    from repro_torch.models import registry
    from repro_torch.serving import engine
    from repro_torch.sharding.placement import Placement
    from repro_torch.sharding.specs import make_plan
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import build_train_step
    plan = None
    if mesh is not None:
        plan = make_plan(mesh, cfg, mode, L=L, train=kind == "train",
                         decode=kind == "decode")
        join_abstract(mesh, coords)
    try:
        aparams = registry.abstract_params(cfg)
        xcfg = plan.xcfg if plan is not None else ExchangeConfig(mode, L=L)
        batch = _batch(cfg, kind, B, N)
        state: Dict = {}
        if kind == "train":
            if plan is not None:
                place, blocks, opt = train_state(plan, cfg, aparams,
                                                 moment_dtype)
                step = build_train_step(cfg, xcfg, grad_accum=grad_accum,
                                        placement=place, acc_dtype=acc_dtype)
            else:
                blocks = aparams
                opt = adamw_init(aparams, moment_dtype)
                step = build_train_step(cfg, xcfg, grad_accum=grad_accum,
                                        acc_dtype=acc_dtype)
            state = dict(params=blocks, moments=(opt.m, opt.v))
            args = (blocks, opt, batch)
        else:
            params = aparams
            if plan is not None:
                place = Placement(plan, cfg, aparams)
                params = (place.param_blocks(aparams) if plan.fsdp
                          else place.held_params(aparams))
                cache = engine.init_cache(cfg, plan, B, N, device=META)
                rows = engine._OnMesh(cfg, plan, False).n_rows(B)
            else:
                from repro_torch.models import transformer as tfm
                cache = tfm.init_decode_cache(cfg, B, N, device=META)
                rows = B
            if kind == "prefill":
                step = engine.build_prefill_step(cfg, xcfg, plan)
                args = (params, batch, cache)
            else:
                if cfg.family in ("audio", "vlm"):
                    cache = _memory_cache(cfg, cache, rows, xcfg)
                step = engine.build_decode_step(cfg, xcfg, plan)
                args = (params, batch, cache, N - 1)
            state = dict(params=params, cache=cache)
        groups = mesh_groups() if plan is not None else []
        for g in groups:
            g.reset_stats()
        arg_bytes = storage_bytes(args)
        t0 = time.perf_counter()
        ctx = torch.no_grad() if kind != "train" else \
            contextlib.nullcontext()
        with ctx, StepCounter() as counter:
            out = step(*args)
            out_bytes = counter.output_bytes(out)
        trace_s = time.perf_counter() - t0
        del out
        return dict(
            counter=counter, plan=plan, trace_s=trace_s,
            argument_bytes=arg_bytes, output_bytes=out_bytes,
            peak_bytes=arg_bytes + counter.peak,
            state_bytes={k: storage_bytes(v) for k, v in state.items()},
            batch_bytes=storage_bytes(batch),
            gather=_gather_stats(groups),
            coords=None if plan is None else mesh_coords())
    finally:
        if mesh is not None:
            leave_mesh()


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               mode: ExchangeMode, L: int = DEFAULT_L,
               grad_accum: Optional[int] = None,
               coords: Optional[Dict[str, int]] = None) -> Dict:
    """Trace one cell's step for one rank (default rank 0) of the
    production mesh, with the JAX cell's settings: bf16 moments and a bf16
    accumulator above 100 GB of params, ``grad_accum_for`` microbatches
    (no more than the rank's rows allow)."""
    from repro_torch.models import registry
    from repro_torch.utils.tree import param_bytes, param_count
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    aparams = registry.abstract_params(cfg)
    big = _param_gb(cfg) > 100
    ga = 1
    if shape.kind == "train":
        from repro_torch.sharding.specs import make_plan
        plan = make_plan(mesh, cfg, mode, L=L, train=True)
        bshards = axis_size(mesh, plan.batch_axes)
        ga = grad_accum_for(cfg) if grad_accum is None else grad_accum
        ga = max(min(ga, shape.global_batch // max(bshards, 1)), 1)
    got = trace_step(cfg, shape.kind, mesh, mode=mode, B=shape.global_batch,
                     N=shape.seq_len, L=L, coords=coords, grad_accum=ga,
                     acc_dtype=torch.bfloat16 if big else torch.float32,
                     moment_dtype=torch.bfloat16 if big else torch.float32)
    return dict(got, cfg=cfg, shape=shape, n_chips=mesh.size,
                n_params=param_count(aparams),
                param_bytes=param_bytes(aparams), grad_accum=ga)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             mode: ExchangeMode, L: int = DEFAULT_L, out_dir=OUT_DIR,
             verbose=True) -> Dict:
    from repro_torch.profiling.hardware import H100_HBM_GB
    meta = lower_cell(arch, shape_name, multi_pod=multi_pod, mode=mode,
                      L=L)
    roof = analysis_dict(meta["counter"].cost(), meta["n_chips"])
    mf = model_flops(meta["cfg"], meta["shape"], meta["n_params"])
    peak = meta["peak_bytes"]
    record = {
        "arch": arch, "shape": shape_name, "mode": mode.value, "L": L,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": meta["n_chips"],
        "coords": meta["coords"],
        "n_params": meta["n_params"],
        "param_bytes": meta["param_bytes"],
        "grad_accum": meta["grad_accum"],
        "trace_s": round(meta["trace_s"], 2),
        "memory": {
            "argument_bytes": meta["argument_bytes"],
            "state_bytes": meta["state_bytes"],
            "batch_bytes": meta["batch_bytes"],
            "output_bytes": meta["output_bytes"],
            "temp_bytes": peak - meta["argument_bytes"],
            "peak_bytes": peak,
            "per_device_total_bytes": peak,
            "fits_80gb": peak < H100_HBM_GB * 1e9,
        },
        "roofline": roof,
        "gather_stats": meta["gather"],
        "model_flops_global": mf,
        "model_flops_per_device": mf / meta["n_chips"],
        "useful_flops_ratio": (mf / meta["n_chips"])
        / max(roof["per_device_flops"], 1.0),
        "counted": "the port's eager program on the meta device, one rank; "
                   "not a measurement",
    }
    if verbose:
        coll = ", ".join(f"{k} {v['received_bytes'] / 1e9:.3f} GB "
                         f"({v['calls']} calls)"
                         for k, v in roof["collectives"].items())
        print(f"[{record['mesh']}] {arch} × {shape_name} × {mode.value}: "
              f"trace {meta['trace_s']:.1f}s, rank peak {peak / 1e9:.2f} GB "
              f"(args {meta['argument_bytes'] / 1e9:.2f} GB, "
              f"fits 80 GB={record['memory']['fits_80gb']}), "
              f"flops/dev {roof['per_device_flops']:.3e}, received "
              f"{roof['per_device_collective_received_bytes']:.3e} B"
              + (f" [{coll}]" if coll else ""), flush=True)
        print(f"    terms: compute {roof['compute_s'] * 1e3:.2f} ms | memory "
              f"{roof['memory_s'] * 1e3:.2f} ms | collective "
              f"{roof['collective_s'] * 1e3:.2f} ms (counted, not measured)",
              flush=True)
    d = os.path.join(out_dir, record["mesh"])
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{arch}__{shape_name}__{mode.value}.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    return record


def all_cells():
    for arch in ASSIGNED_ARCHS:
        for shape in shapes_for(arch):
            yield arch, shape.name


def _run_one(arch: str, shape: str, multi_pod: bool, mode: Optional[str],
             L: int, out_dir: str) -> Optional[str]:
    """One cell under ``mode`` (None: ``default_mode``) → None, or the
    failure's text."""
    cfg = get_config(arch)
    m = (ExchangeMode(mode) if mode
         else default_mode(cfg, SHAPES_BY_NAME[shape].kind))
    try:
        run_cell(arch, shape, multi_pod=multi_pod, mode=m, L=L,
                 out_dir=out_dir)
    except Exception as e:
        print(f"FAILED [{'2x16x16' if multi_pod else '16x16'}] {arch} × "
              f"{shape}: {e}", flush=True)
        traceback.print_exc()
        return repr(e)
    finally:
        gc.collect()
    return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mode", default=None,
                    choices=["prism", "voltage", "local"])
    ap.add_argument("--L", type=int, default=DEFAULT_L)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its "
                         "own (1: in this process)")
    args = ap.parse_args(argv)
    if not args.all and not args.arch:
        ap.error("give --arch (and --shape), or --all")

    archs = args.arch.split(",") if args.arch else None
    cells = [(a, s) for a, s in all_cells()
             if (archs is None or a in archs)
             and (args.shape is None or s == args.shape)]
    if not cells:
        ap.error(f"no cell of --arch {args.arch} --shape {args.shape}")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    jobs = [(arch, shape, mp, args.mode, args.L, args.out)
            for arch, shape in cells for mp in meshes]
    t0 = time.perf_counter()
    if args.jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        # the long traces first: training steps, and xLSTM's time loops
        order = sorted(range(len(jobs)), key=lambda i: (
            jobs[i][0] != "xlstm-350m" and
            SHAPES_BY_NAME[jobs[i][1]].kind != "train"))
        with ProcessPoolExecutor(
                args.jobs,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            done = dict(zip(order, pool.map(
                _run_one, *zip(*[jobs[i] for i in order]))))
        errors = [done[i] for i in range(len(jobs))]
    else:
        errors = [_run_one(*job) for job in jobs]
    failures = [(arch, shape, mp, e) for (arch, shape, mp, *_), e
                in zip(jobs, errors) if e is not None]
    print(f"{len(jobs)} cells traced in {time.perf_counter() - t0:.1f} s")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nALL DRY-RUN CELLS PASSED")


if __name__ == "__main__":
    main()
