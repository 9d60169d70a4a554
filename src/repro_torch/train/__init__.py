"""`repro_torch.train` — port of ``repro.train``: AdamW, the loss and the
train step, the fault-tolerant trainer and gradient compression."""
from repro_torch.train.optimizer import (AdamWState, OptConfig, adamw_init,
                                         adamw_update)
from repro_torch.train.train_step import (build_eval_step, build_train_step,
                                          loss_fn)

__all__ = ["AdamWState", "OptConfig", "adamw_init", "adamw_update",
           "build_eval_step", "build_train_step", "loss_fn"]
