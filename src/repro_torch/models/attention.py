"""GQA self-attention of the port (train/prefill, no cache).

Port of the no-cache branch of ``repro/models/attention.py::
apply_self_attention``: q/k/v projections, optional per-head qk RMSNorm,
RoPE at positions 0..S-1, then ``flash_attention`` with the layer's
window and the config's logit softcap.  Layout [B, S, H, D] throughout.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

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
