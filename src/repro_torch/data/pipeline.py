"""Deterministic synthetic token batches.

Port of ``repro/data/pipeline.py::make_batch`` (text configs): batch
``step`` is a pure function of ``(seed, step)``.  The stream has the same
structure as the JAX package's — a Zipf(1.1) first token, then each next
token follows a seeded vocabulary permutation with probability 0.7 and
is a fresh Zipf draw otherwise — but is drawn with numpy, so the tokens
differ from ``jax.random``'s; parity tests feed both packages the same
numpy batch.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def _zipf_cdf(vocab: int, exponent: float = 1.1) -> np.ndarray:
    w = np.arange(1, vocab + 1, dtype=np.float64) ** -exponent
    return np.cumsum(w / w.sum())


def make_batch(cfg: ArchConfig, seed: int, step: int, batch: int,
               seq_len: int, *, device="cuda") -> Dict[str, torch.Tensor]:
    """One global batch: int64 tokens [batch, seq_len] and labels."""
    if cfg.modality != "text":
        raise NotImplementedError("stub modality memory is not ported yet")
    v = cfg.vocab_size
    rng = np.random.default_rng([seed, step])
    perm = np.random.default_rng(seed + 1).permutation(v)
    cdf = _zipf_cdf(v)
    draw = lambda shape: np.minimum(
        np.searchsorted(cdf, rng.random(shape), side="right"), v - 1)
    toks = np.empty((seq_len, batch), dtype=np.int64)
    toks[0] = draw(batch)
    follow = rng.random((seq_len - 1, batch)) < 0.7
    rand = draw((seq_len - 1, batch))
    for t in range(1, seq_len):
        toks[t] = np.where(follow[t - 1], perm[toks[t - 1]], rand[t - 1])
    tokens = torch.from_numpy(np.ascontiguousarray(toks.T)).to(device)
    return {"tokens": tokens, "labels": tokens}
