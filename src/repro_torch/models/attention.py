"""GQA self-attention, cross-attention and Multi-head Latent Attention of
the port (train/prefill, no cache).

Port of the no-cache branch of ``repro/models/attention.py::
apply_self_attention``: q/k/v projections, optional per-head qk RMSNorm,
RoPE at positions 0..S-1, then ``flash_attention`` with the layer's
window and the config's logit softcap; and of its cross-attention
(``init_cross_attention``, ``cross_kv``, ``apply_cross_attention``): the
queries attend, without a mask and without RoPE, to K/V projected from a
memory (the encoder's output or the stub frontend's embeddings), with an
optional ``tanh(gate)`` on the output (the VLM's gated block); and of
DeepSeek-V2's MLA train path (``init_mla``, ``_mla_q``, ``_mla_latent``
and ``apply_mla``'s expanded branch): q through a low-rank down / up
projection with ``q_norm``, K and V expanded from the normed latent
``ckv``, RoPE on the q_rope half and on the one k_rope shared by every
head, then ``flash_attention`` at d_qk = qk_nope + qk_rope over
d_v = v_head_dim.  MLA's absorbed decode over the latent cache belongs to
serving and is not ported.  Layout [B, S, H, D] throughout.
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


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V2), train path
# ---------------------------------------------------------------------------
def init_mla(generator, cfg, *, lead: Sequence[int] = (), device="cuda",
             dtype=torch.float32) -> Dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    kw = dict(lead=lead, device=device, dtype=dtype)
    z = lambda n: torch.zeros((*lead, n), dtype=dtype, device=device)
    return {
        "wdq": dense_init(generator, d, m.q_lora_rank, **kw),
        "q_norm": z(m.q_lora_rank),
        "wuq": dense_init(generator, m.q_lora_rank, h * qk_head, **kw),
        "wdkv": dense_init(generator, d, m.kv_lora_rank + m.qk_rope_head_dim,
                           **kw),
        "kv_norm": z(m.kv_lora_rank),
        "wuk": dense_init(generator, m.kv_lora_rank, h * m.qk_nope_head_dim,
                          **kw),
        "wuv": dense_init(generator, m.kv_lora_rank, h * m.v_head_dim, **kw),
        "wo": dense_init(generator, h * m.v_head_dim, d, **kw),
    }


def _mla_q(p, x, cfg, pos):
    """(q_nope, q_rope) [B, S, H, .], RoPE on q_rope."""
    m = cfg.mla
    b, s, _ = x.shape
    cq = rms_norm_per_head(x @ p["wdq"], p["q_norm"])
    q = (cq @ p["wuq"]).reshape(b, s, cfg.n_heads,
                                m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, apply_rope(q_rope, pos, cfg.rope_theta)


def _mla_latent(p, x, cfg, pos):
    """(ckv [B, S, kv_lora] normed, k_rope [B, S, rope] rotated)."""
    m = cfg.mla
    dkv = x @ p["wdkv"]
    ckv = rms_norm_per_head(dkv[..., :m.kv_lora_rank], p["kv_norm"])
    # the rope key is shared across heads: a singleton head dim to rotate
    k_rope = apply_rope(dkv[..., m.kv_lora_rank:][:, :, None, :], pos,
                        cfg.rope_theta)[:, :, 0, :]
    return ckv, k_rope


def apply_mla(p: Dict, x: torch.Tensor, *, cfg, cache=None,
              attn_impl: Optional[str] = None) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d], causal, K/V expanded from the latent."""
    if cache is not None:
        raise NotImplementedError(
            "MLA's absorbed decode over the latent cache belongs to serving, "
            "which is not ported yet (see ROADMAP.md)")
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    pos = torch.arange(s, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, pos)
    ckv, k_rope = _mla_latent(p, x, cfg, pos)
    k_nope = (ckv @ p["wuk"]).reshape(b, s, h, m.qk_nope_head_dim)
    vv = (ckv @ p["wuv"]).reshape(b, s, h, m.v_head_dim)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, m.qk_rope_head_dim)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    att = flash_attention(q_full, k_full, vv, causal=True, impl=attn_impl)
    return att.reshape(b, s, -1) @ p["wo"]
