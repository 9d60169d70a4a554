from repro_torch.kernels.prism_attention.kernel import prism_attention
from repro_torch.kernels.prism_attention.ops import (build_mean_bias,
                                                     prism_attention_op)
from repro_torch.kernels.prism_attention.ref import prism_attention_ref

__all__ = ["build_mean_bias", "prism_attention", "prism_attention_op",
           "prism_attention_ref"]
