from repro_torch.kernels.segment_means.kernel import (segment_means,
                                                      segment_means_kv)
from repro_torch.kernels.segment_means.ops import (segment_means_kv_op,
                                                   segment_means_op)
from repro_torch.kernels.segment_means.ref import segment_means_ref

__all__ = ["segment_means", "segment_means_kv", "segment_means_kv_op",
           "segment_means_op", "segment_means_ref"]
