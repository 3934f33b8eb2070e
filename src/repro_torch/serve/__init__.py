"""Serving substrate of the port: prefill / decode steps."""
from repro_torch.serve.steps import (
    decode_serve_step,
    make_serve_cache,
    prefill_serve_step,
)

__all__ = ["make_serve_cache", "prefill_serve_step", "decode_serve_step"]
