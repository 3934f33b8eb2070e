"""Deterministic synthetic batches.

Port of ``repro/data/pipeline.py::make_batch``: batch ``step`` is a pure
function of ``(seed, step)``.  The token stream has the same structure as
the JAX package's — a Zipf(1.1) first token, then each next token follows
a seeded vocabulary permutation with probability 0.7 and is a fresh Zipf
draw otherwise — but is drawn with numpy, so the tokens differ from
``jax.random``'s; parity tests feed both packages the same numpy batch.
Audio and vision configs also get the stub frontend's ``memory``
(standard normal x 0.02 frame / patch embeddings), drawn from a numpy
stream of its own so the tokens are the same with or without it.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


# the third word of the memory stream's seed: the token stream's is (seed, step)
_MEMORY_STREAM = 0x6D656D


def _zipf_cdf(vocab: int, exponent: float = 1.1) -> np.ndarray:
    w = np.arange(1, vocab + 1, dtype=np.float64) ** -exponent
    return np.cumsum(w / w.sum())


def make_batch(cfg: ArchConfig, seed: int, step: int, batch: int,
               seq_len: int, *, device="cuda") -> Dict[str, torch.Tensor]:
    """One global batch: int64 tokens [batch, seq_len] and labels, plus
    f32 ``memory`` [batch, n_modal_tokens, d_model] for a non-text
    modality."""
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
    out = {"tokens": tokens, "labels": tokens}
    if cfg.modality != "text":
        mem = np.random.default_rng([seed, step, _MEMORY_STREAM]) \
            .standard_normal((batch, cfg.n_modal_tokens, cfg.d_model),
                             dtype=np.float32)
        out["memory"] = torch.from_numpy(mem * np.float32(0.02)).to(device)
    return out
