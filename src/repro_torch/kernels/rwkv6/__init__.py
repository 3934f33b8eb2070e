from repro_torch.kernels.rwkv6.ops import (
    rwkv6_bwd_cuda,
    rwkv6_bwd_plain,
    rwkv6_chunked_plain,
    rwkv6_fwd_cuda,
    rwkv6_mix,
    rwkv6_reference_plain,
)

__all__ = ["rwkv6_bwd_cuda", "rwkv6_bwd_plain", "rwkv6_chunked_plain",
           "rwkv6_fwd_cuda", "rwkv6_mix", "rwkv6_reference_plain"]
