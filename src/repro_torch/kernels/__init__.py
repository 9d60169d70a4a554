# Hand-written Hopper kernels for the runtime's hot paths + the dispatch
# layer that routes them by the device of the tensors they are given.
from repro_torch.kernels.dispatch import backend_info

__all__ = ["backend_info"]
