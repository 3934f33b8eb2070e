"""Naive attention of the port over a cache: plain PyTorch.

Port of ``repro/kernels/flash_attention/ref.py::attention_reference``,
which the JAX package runs (``impl="ref"``) for every self-attention call
over a full KV cache, at prefill and at decode: O(Sq * Sk) scores with
causal masking at absolute query positions ``q_offset + i``, a sliding
window, the logit softcap, GQA head grouping and a valid key prefix
``kv_length`` per batch row.  ``k_pos`` gives the keys' absolute
positions where they are not ``0..Sk-1`` (a ring buffer's slots, JAX's
``_ring_attention``), and keys below ``oldest`` are masked.  The
expression order is JAX's: q divided by
sqrt(D), the softcap, masking with -1e30, then the softmax, in f32, with
the output in q's dtype.  No Pallas kernel runs there in the JAX package,
so this stays plain on the card too.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ops import NEG_INF


def attention_reference(
    q: torch.Tensor,              # [B, Sq, H, D]
    k: torch.Tensor,              # [B, Sk, KV, D]
    v: torch.Tensor,              # [B, Sk, KV, DV]
    *,
    causal: bool = True,
    window: int = 0,              # 0 = unlimited; else causal sliding window
    softcap: float = 0.0,
    q_offset: int = 0,            # absolute position of q[:, 0]
    kv_length: Optional[torch.Tensor] = None,   # valid kv prefix [B], int
    k_pos: Optional[torch.Tensor] = None,       # keys' positions [Sk]
    oldest: int = 0,              # the first position a key may hold
) -> torch.Tensor:
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if h % kvh:
        raise ValueError(f"heads {h} do not group over {kvh} kv heads")
    group = h // kvh
    qf = q.float() / torch.sqrt(torch.tensor(float(d), dtype=torch.float32,
                                             device=q.device))
    # expand kv heads to full heads
    kf = torch.repeat_interleave(k.float(), group, dim=2)
    vf = torch.repeat_interleave(v.float(), group, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]   # [Sq, 1]
    if k_pos is None:
        k_pos = torch.arange(sk, device=q.device)
    kpos = k_pos[None, :]                                          # [1, Sk]
    mask = kpos >= oldest
    if causal:
        mask = mask & (kpos <= qpos)
    if window:
        mask = mask & (kpos > qpos - window)
    mask = mask[None, None]
    if kv_length is not None:
        mask = mask & (kpos[None, None] < kv_length.to(q.device)[:, None,
                                                                   None, None])
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf)
    return out.to(q.dtype)
