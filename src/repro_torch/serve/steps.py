"""Prefill / decode steps of the port for the inference shapes.

Port of ``repro/serve/steps.py``'s steps: ``make_serve_cache`` (the
model's decode cache, bf16 by default as in JAX), ``prefill_serve_step``
(batched prompt ingestion) and ``decode_serve_step`` (one new token a
row against the cache).  The cache is written in place, the counterpart
of JAX's donated cache, so each step returns only its logits.  JAX's
``cache_specs`` / ``cache_shardings`` shard the cache over the ``model``
mesh axis, which the port's serving does not take yet (ROADMAP item 8.4).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import decode_step, init_cache, prefill


def make_serve_cache(cfg: ArchConfig, batch: int, max_len: int, *,
                     device="cuda", dtype=torch.bfloat16,
                     prefill_chunk: int = 1) -> Dict:
    return init_cache(cfg, batch, max_len, device=device, dtype=dtype,
                      prefill_chunk=prefill_chunk)


def prefill_serve_step(params, tokens: torch.Tensor, cache: Dict, *,
                       cfg: ArchConfig,
                       memory: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched prompt ingestion: tokens [B, S] -> last-position logits
    [B, V]; ``cache`` is filled in place."""
    return prefill(params, cfg, tokens, cache, memory=memory)


def decode_serve_step(params, token: torch.Tensor, cache: Dict, pos: int, *,
                      cfg: ArchConfig,
                      kv_length: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """One decode step: [B] token ids at absolute position ``pos`` in,
    [B, V] logits out; ``cache`` is written in place."""
    return decode_step(params, cfg, token, cache, pos, kv_length=kv_length)
