from repro_torch.kernels.rglru.ops import (
    rglru_bwd_cuda,
    rglru_fwd_cuda,
    rglru_scan,
    rglru_scan_bwd_plain,
    rglru_scan_plain,
)

__all__ = ["rglru_bwd_cuda", "rglru_fwd_cuda", "rglru_scan",
           "rglru_scan_bwd_plain", "rglru_scan_plain"]
