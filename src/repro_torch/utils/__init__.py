from repro_torch.utils.bandwidth import BandwidthEstimator
from repro_torch.utils.timing import Timer, timeit_torch

__all__ = ["BandwidthEstimator", "Timer", "timeit_torch"]
