"""GQA self-attention and cross-attention of the port (train/prefill, no
cache).

Port of the no-cache branch of ``repro/models/attention.py::
apply_self_attention``: q/k/v projections, optional per-head qk RMSNorm,
RoPE at positions 0..S-1, then ``flash_attention`` with the layer's
window and the config's logit softcap; and of its cross-attention
(``init_cross_attention``, ``cross_kv``, ``apply_cross_attention``): the
queries attend, without a mask and without RoPE, to K/V projected from a
memory (the encoder's output or the stub frontend's embeddings), with an
optional ``tanh(gate)`` on the output (the VLM's gated block).  Layout
[B, S, H, D] throughout.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import apply_rope, dense_init, rms_norm_per_head


def init_attention(generator, cfg, *, lead: Sequence[int] = (), device="cuda",
                   dtype=torch.float32) -> Dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    kw = dict(lead=lead, device=device, dtype=dtype)
    p = {
        "wq": dense_init(generator, d, cfg.n_heads * hd, **kw),
        "wk": dense_init(generator, d, cfg.n_kv_heads * hd, **kw),
        "wv": dense_init(generator, d, cfg.n_kv_heads * hd, **kw),
        "wo": dense_init(generator, cfg.n_heads * hd, d, **kw),
    }
    if cfg.use_qk_norm:
        p["q_norm"] = torch.zeros((*lead, hd), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((*lead, hd), dtype=dtype, device=device)
    return p


def _project_qkv(p, x, cfg):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.use_qk_norm:
        q = rms_norm_per_head(q, p["q_norm"])
        k = rms_norm_per_head(k, p["k_norm"])
    return q, k, v


def apply_self_attention(p: Dict, x: torch.Tensor, *, cfg, window: int = 0,
                         causal: bool = True,
                         attn_impl: Optional[str] = None) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d]."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    pos = torch.arange(s, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    att = flash_attention(q, k, v, causal=causal, window=window,
                          softcap=cfg.attn_logit_softcap, impl=attn_impl)
    return att.reshape(b, s, -1) @ p["wo"]


def init_cross_attention(generator, cfg, *, lead: Sequence[int] = (),
                         device="cuda", dtype=torch.float32) -> Dict:
    """``init_attention``'s params plus the 0-d ``gate`` (0: closed)."""
    p = init_attention(generator, cfg, lead=lead, device=device, dtype=dtype)
    p["gate"] = torch.zeros(tuple(lead), dtype=dtype, device=device)
    return p


def cross_kv(p: Dict, memory: torch.Tensor, cfg
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """memory [B, M, d] -> K, V [B, M, KV, D] (K per-head normed with
    ``use_qk_norm``)."""
    b, m, _ = memory.shape
    hd = cfg.resolved_head_dim
    k = (memory @ p["wk"]).reshape(b, m, cfg.n_kv_heads, hd)
    v = (memory @ p["wv"]).reshape(b, m, cfg.n_kv_heads, hd)
    if cfg.use_qk_norm:
        k = rms_norm_per_head(k, p["k_norm"])
    return k, v


def apply_cross_attention(p: Dict, x: torch.Tensor,
                          kv: Tuple[torch.Tensor, torch.Tensor], *, cfg,
                          gated: bool = False,
                          attn_impl: Optional[str] = None) -> torch.Tensor:
    """x [B, S, d] attends to ``kv`` (``cross_kv``) -> [B, S, d]."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, hd)
    if cfg.use_qk_norm:
        q = rms_norm_per_head(q, p["q_norm"])
    k, v = kv
    att = flash_attention(q, k, v, causal=False,
                          softcap=cfg.attn_logit_softcap, impl=attn_impl)
    out = att.reshape(b, s, -1) @ p["wo"]
    if gated:
        out = torch.tanh(p["gate"].float()).to(out.dtype) * out
    return out
