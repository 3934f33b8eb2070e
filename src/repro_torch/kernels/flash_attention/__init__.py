from repro_torch.kernels.flash_attention.ops import (
    flash_attention,
    flash_bwd_plain,
    flash_fwd_cuda,
    flash_fwd_plain,
)

__all__ = ["flash_attention", "flash_bwd_plain", "flash_fwd_cuda",
           "flash_fwd_plain"]
