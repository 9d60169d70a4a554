from repro_torch.data.pipeline import SyntheticImageDataset

__all__ = ["SyntheticImageDataset"]
