from repro_torch.models.model import (
    decode_step,
    encode,
    forward,
    init_cache,
    init_params,
    loss_fn,
    prefill,
    stack_layout,
)

__all__ = [
    "decode_step", "encode", "forward", "init_cache", "init_params",
    "loss_fn", "prefill", "stack_layout",
]
