from repro_torch.data.pipeline import (Prefetcher, SyntheticImageDataset,
                                       SyntheticLMDataset, make_lm_batch,
                                       synthetic_vit_task)

__all__ = ["Prefetcher", "SyntheticImageDataset", "SyntheticLMDataset",
           "make_lm_batch", "synthetic_vit_task"]
