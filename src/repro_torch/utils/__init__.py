from repro_torch.utils.bandwidth import BandwidthEstimator

__all__ = ["BandwidthEstimator"]
