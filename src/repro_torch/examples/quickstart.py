"""Quickstart: the paper's Fig. 1 pipeline end to end on one device,
entirely through ``repro_torch.api`` (the port's twin of
``examples/quickstart.py``).

1. Offline profiling sweep (B × CR × BW) → performance map (JSON).
2. Runtime adaptive policy: per-batch choice of local vs distributed(CR),
   explained with the paper's crossover artifacts.
3. PRISM inference on ViT: full attention vs Segment-Means attention agree.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.api import ExecutionPlan, InferenceSession
from repro_torch.data.pipeline import SyntheticImageDataset


def main(argv=None, *, params=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--perfmap", default=os.path.join(
        tempfile.gettempdir(), "prism_perfmap_torch.json"),
        help="where the performance map is saved")
    args = ap.parse_args(argv)

    # one session owns params, per-plan executables, perf map, and policy
    session = InferenceSession.from_config(
        "vit-base-16",
        plans=[ExecutionPlan.local(),
               ExecutionPlan.prism_sim(L=20, cr=4.95)],
        params=params, device=args.device)

    # --- 1. offline profiling (paper §3.3) -------------------------------
    # backend="simulated" is the cost-model sweep; "measured" would time
    # this session's own executables, "trace" replays a saved map
    pm = session.profile(backend="simulated", save_path=args.perfmap)
    print(f"[1] profiled {len(pm)} configurations on {pm.hardware.name} "
          f"→ {args.perfmap}")

    # --- 2. runtime adaptive policy --------------------------------------
    for batch, bw in ((1, 400), (8, 400), (32, 400), (8, 200), (8, 900)):
        d = session.decide(batch, bw)
        print(f"[2] B={batch:<3} BW={bw:<4} → {d.mode:<6} CR={d.cr:<5} "
              f"expect {d.expected.per_sample_ms:7.1f} ms/sample")
    exp = session.explain(8, 400.0)
    print(f"[2] batch crossover @400Mbps: {exp.batch_crossover} (paper: 8); "
          f"bandwidth crossover @B=8: {exp.bandwidth_crossover:g} Mbps "
          f"(paper: ≈340)")

    # --- 3. PRISM attention on ViT ----------------------------------------
    imgs, labels = SyntheticImageDataset(batch_size=4).sample(
        np.random.RandomState(0))
    batch = {"images": torch.from_numpy(imgs)}
    lg_full = session.run("local", batch)
    lg_prism = session.run("prism@4.95", batch)
    agree = (lg_full.argmax(-1) == lg_prism.argmax(-1)).float().mean()
    print(f"[3] ViT local-vs-PRISM(CR≈4.9) prediction agreement: "
          f"{float(agree) * 100:.0f}%")
    print("QUICKSTART OK")


if __name__ == "__main__":
    main()
