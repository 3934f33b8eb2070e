from repro_torch.kernels.flash_attention.ops import (
    flash_attention,
    flash_bwd_plain,
    flash_fwd_cuda,
    flash_fwd_plain,
)
from repro_torch.kernels.flash_attention.ref import attention_reference

__all__ = ["attention_reference", "flash_attention", "flash_bwd_plain",
           "flash_fwd_cuda", "flash_fwd_plain"]
