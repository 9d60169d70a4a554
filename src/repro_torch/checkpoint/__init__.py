from repro_torch.checkpoint.manager import (CheckpointManager, latest_step,
                                            load_pytree, save_pytree)

__all__ = ["CheckpointManager", "latest_step", "load_pytree", "save_pytree"]
