"""Adaptive serving (paper §3.3 runtime) through ``repro_torch.api`` (the
port's twin of ``examples/serve_adaptive.py``): one ``InferenceSession``
profiles offline through a pluggable backend, routes each arriving
request batch between its local and PRISM executables per profiled
performance and observed bandwidth, folds the observed wall times back
into the profile (``calibrate()``), and finally generates tokens.

    PYTHONPATH=src python -m repro_torch.examples.serve_adaptive [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.api import (ExecutionPlan, InferenceSession, SLOObjective,
                             WeightedObjective)


def main(argv=None, *, params=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    # executables per plan (one device: PRISM runs in simulation form)
    session = InferenceSession.from_config(
        "llama3.2-1b", reduced={"vocab_size": 128},
        plans=[ExecutionPlan.local(),
               ExecutionPlan.prism_sim(L=4, cr=9.9)],
        params=params, device=args.device)
    pm = session.profile(backend="simulated")       # paper's offline sweep
    print(f"profiled {len(pm)} configurations on {pm.hardware.name}")

    rng = np.random.RandomState(0)
    V = session.cfg.vocab_size
    for step, (batch_size, bw) in enumerate(
            [(1, 400), (4, 420), (8, 380), (16, 390), (32, 250), (8, 200),
             (64, 400)]):                            # 64 is off the grid
        session.observe_bandwidth(bw)
        toks = torch.from_numpy(rng.randint(0, V, (batch_size, 32)))
        session.dispatch({"tokens": toks})
        rec = session.history[-1]
        print(f"req {step}: B={batch_size:<3} bw~{session.bandwidth:5.0f} "
              f"Mbps → {rec.decision.mode:<6} CR={rec.decision.cr:<5} "
              f"exec={rec.exec_key:<10} ({rec.wall_ms:6.1f} ms wall)"
              + ("  [extrapolated]" if rec.extrapolated else ""))

    # why did the B=8 requests route the way they did?
    print(session.explain(8, 400.0).summary())

    # objectives beyond latency: energy under an SLO, weighted tradeoff
    for obj in ("energy", WeightedObjective(1.0, 0.5), SLOObjective(60.0)):
        d = session.decide(8, 400.0, objective=obj)
        print(f"objective {obj!r:<28} → {d.mode} CR={d.cr:g}")

    # closed-loop: fold the observed wall times back into the profile
    report = session.calibrate()
    print(f"calibrate: {report.updated} entries EWMA-updated, "
          f"{report.skipped_extrapolated} off-grid record(s) skipped")

    # token generation on the session's local plan (flash-decode on the card)
    prompt = torch.from_numpy(rng.randint(0, V, (2, 8)))
    out = session.generate(prompt, n_new=8)
    print("generated tokens:", out.cpu().numpy())
    print("SERVE ADAPTIVE OK")


if __name__ == "__main__":
    main()
