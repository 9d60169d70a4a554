"""End-to-end training run (the port's twin of ``examples/train_lm.py``):
a reduced llama on the synthetic Markov LM stream for a few hundred steps
with checkpoints every 50 steps through the fault-tolerant loop.  Every
layer is rematerialised in the backward (``repro_torch.models.remat``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] \\
        [--arch llama3.2-1b] [--mode local|prism_sim] [--device cpu]

The checkpoints go to a fresh temporary directory, removed at the end, so
a run never resumes an earlier one; ``--ckpt-dir`` keeps them (a second
run with the same directory then resumes from its newest step, as the
reference's fixed directory does).
"""
import argparse
import contextlib
import tempfile

import numpy as np

from repro_torch.api import ExecutionPlan
from repro_torch.configs import get_config
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.optimizer import OptConfig


def main(argv=None, *, params=None):
    """Train, print the loss drop and ``TRAIN LM OK`` → the per-step
    losses."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--mode", default="local",
                    choices=["local", "prism_sim"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced(vocab_size=256, n_layers=4,
                                        d_model=128, d_ff=256)
    plan = (ExecutionPlan.local() if args.mode == "local" else
            ExecutionPlan.prism_sim(L=4, seq_shards=4))
    xcfg = plan.to_exchange_config()
    with contextlib.ExitStack() as stack:
        ckpt_dir = args.ckpt_dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="repro_torch_train_lm_"))
        tr = Trainer(cfg, xcfg, TrainerConfig(
            steps=args.steps, ckpt_every=50, ckpt_dir=ckpt_dir,
            batch_size=8, seq_len=128),
            opt_cfg=OptConfig(lr=1e-3, warmup_steps=10,
                              total_steps=args.steps),
            device=args.device, params=params)
        tr.run(args.steps)
    losses = [m["loss"] for m in tr.metrics_log]
    k = max(len(losses) // 10, 1)
    print(f"steps: {len(losses)}  loss {np.mean(losses[:k]):.3f} → "
          f"{np.mean(losses[-k:]):.3f}")
    if not np.mean(losses[-k:]) < np.mean(losses[:k]):
        raise AssertionError("did not learn!")
    print("TRAIN LM OK")
    return losses


if __name__ == "__main__":
    main()
