"""Paper Table 3 mechanism on the synthetic image task (the port's twin of
``examples/finetune_prism.py`` and of ``benchmarks/accuracy_prism.py``,
which it carries): accuracy drops under Segment-Means compression, and
fine-tuning THROUGH the compressed attention recovers it.

CIFAR-10 and a pretrained ViT are not available offline, so this
validates the *mechanism* at laptop scale: train a small ViT on the
synthetic structured-image task (``data/pipeline.py``), evaluate full vs
``prism_sim`` at the paper's CRs, then fine-tune through the PRISM
approximation and evaluate again.  Training rematerialises each block
(``repro_torch.models.remat``).

    PYTHONPATH=src python -m repro_torch.examples.finetune_prism \\
        [--device cpu] [--train-steps 60] [--ft-steps 25]
"""
import argparse
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.api import ExecutionPlan
from repro_torch.configs import get_config
from repro_torch.core.segment_means import cr_to_L
from repro_torch.data.pipeline import SyntheticImageDataset
from repro_torch.models import registry
from repro_torch.train.optimizer import (OptConfig, adamw_init, adamw_update,
                                         decay_mask)
from repro_torch.utils.tree import tree_leaves, tree_unflatten_like


def vit_config(dtype: Optional[str] = None):
    """The small ViT of the mechanism (4 layers, d 64, 10 classes), in the
    reduced config's bf16 unless ``dtype`` says otherwise."""
    over = {} if dtype is None else {"dtype": dtype}
    return get_config("vit-base-16").reduced(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=10, **over)


def _train(cfg, params, xcfg, ds, steps, lr=3e-4, seed=0,
           losses: Optional[List[float]] = None):
    """``steps`` AdamW steps of the one-hot cross-entropy over the ViT's
    class logits under ``xcfg`` → the new params (each step's loss
    appended to ``losses``)."""
    opt = adamw_init(params)
    ocfg = OptConfig(lr=lr, warmup_steps=10, total_steps=steps,
                     weight_decay=0.01)
    fwd = registry.forward_fn(cfg)
    decay = decay_mask(params, cfg)
    device = tree_leaves(params)[0].device

    def step(params, opt, imgs, labels):
        live = [p.detach().requires_grad_(p.is_floating_point())
                for p in tree_leaves(params)]
        logits, _ = fwd(tree_unflatten_like(params, live),
                        {"images": imgs}, xcfg)
        onehot = F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
        loss = -torch.mean(torch.sum(F.log_softmax(logits, dim=-1) * onehot,
                                     dim=-1))
        grads = torch.autograd.grad(loss, live)
        params, opt, _ = adamw_update(tree_unflatten_like(params, grads),
                                      opt, params, ocfg, decay)
        return params, opt, loss.detach()

    rng = np.random.RandomState(seed)
    for _ in range(steps):
        imgs, labels = ds.sample(rng)
        params, opt, loss = step(params, opt,
                                 torch.from_numpy(imgs).to(device),
                                 torch.from_numpy(labels).to(device))
        if losses is not None:
            losses.append(float(loss))
    return params


@torch.no_grad()
def _acc(cfg, params, xcfg, ds, n_batches=8, seed=123):
    """Top-1 accuracy over ``n_batches`` batches drawn from ``seed``."""
    fwd = registry.forward_fn(cfg)
    device = tree_leaves(params)[0].device
    rng = np.random.RandomState(seed)
    hits = tot = 0
    for _ in range(n_batches):
        imgs, labels = ds.sample(rng)
        logits = fwd(params, {"images": torch.from_numpy(imgs).to(device)},
                     xcfg)[0]
        pred = logits.argmax(-1).cpu().numpy()
        hits += int((pred == labels).sum())
        tot += len(labels)
    return hits / tot


def run(train_steps=60, ft_steps=25, *, device="cuda", params=None):
    """Train, evaluate full and PRISM at CR 3.3 / 4.95 / 9.9, fine-tune
    through CR 9.9 and evaluate again → {"full": acc, "prism": {cr: acc},
    "finetuned": {9.9: acc}}.  ``params`` replaces the seeded draw."""
    cfg = vit_config()
    ds = SyntheticImageDataset(batch_size=16, seed=0)
    if params is None:
        params = registry.init_params(cfg, seed=0, device=device)
    local = ExecutionPlan.local().to_exchange_config()
    params = _train(cfg, params, local, ds, train_steps)
    acc_full = _acc(cfg, params, local, ds)
    print("# PRISM accuracy mechanism (synthetic task; paper Table 3)")
    print(f"full attention accuracy: {acc_full:.3f}")
    out = {"full": acc_full, "prism": {}, "finetuned": {}}
    P = 2
    for cr in (3.3, 4.95, 9.9):
        L = cr_to_L(197, P, cr)
        xp = ExecutionPlan.prism_sim(L=L, cr=cr,
                                     seq_shards=P).to_exchange_config()
        acc = _acc(cfg, params, xp, ds)
        out["prism"][cr] = acc
        print(f"PRISM CR={cr:<5} L={L:<3} accuracy: {acc:.3f} "
              f"(drop {acc_full - acc:+.3f})")
    # fine-tune THROUGH the highest compression (paper's recovery)
    L = cr_to_L(197, P, 9.9)
    xp = ExecutionPlan.prism_sim(L=L, cr=9.9,
                                 seq_shards=P).to_exchange_config()
    params_ft = _train(cfg, params, xp, ds, ft_steps, lr=1e-4, seed=7)
    acc_ft = _acc(cfg, params_ft, xp, ds)
    out["finetuned"][9.9] = acc_ft
    print(f"PRISM CR=9.9 after fine-tune: {acc_ft:.3f} "
          f"(recovered {acc_ft - out['prism'][9.9]:+.3f})")
    return out


def main(argv=None, *, params=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--train-steps", type=int, default=60)
    ap.add_argument("--ft-steps", type=int, default=25)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card; pass --device "
                           "cpu to run on the CPU")
    out = run(args.train_steps, args.ft_steps, device=args.device,
              params=params)
    drop = out["full"] - out["prism"][9.9]
    rec = out["finetuned"][9.9] - out["prism"][9.9]
    print(f"\nsummary: full {out['full']:.3f}; CR=9.9 drop {drop:+.3f}; "
          f"fine-tune recovery {rec:+.3f}")
    print("FINETUNE PRISM OK")
    return out


if __name__ == "__main__":
    main()
