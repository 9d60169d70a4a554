from repro_torch.kernels.flash_decode.kernel import flash_decode
from repro_torch.kernels.flash_decode.ops import (flash_decode_op,
                                                  merge_partials,
                                                  validity_bias,
                                                  validity_mask)
from repro_torch.kernels.flash_decode.paged import (flash_decode_paged,
                                                    flash_decode_paged_op,
                                                    flash_decode_paged_ref,
                                                    gather_pages)
from repro_torch.kernels.flash_decode.ref import flash_decode_ref

__all__ = ["flash_decode", "flash_decode_op", "flash_decode_ref",
           "flash_decode_paged", "flash_decode_paged_op",
           "flash_decode_paged_ref", "gather_pages",
           "merge_partials", "validity_bias", "validity_mask"]
