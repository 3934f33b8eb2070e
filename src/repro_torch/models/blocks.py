"""Decoder block of the port: (norm -> sequence mixer -> residual) ->
(norm -> FFN -> residual), with gemma2-style post-norms when
``cfg.post_block_norm``.

Port of ``repro/models/blocks.py`` for the attention kinds (``attn``,
``local_attn``) and the RG-LRU recurrent block (``rglru``), each with a
dense FFN, and the RWKV-6 block (``rwkv``), whose mixer is the time-mix
and whose FFN sublayer is the RWKV channel-mix (token-shifted
squared-relu MLP).  The other mixers (MLA, cross-attention) and MoE are
later slices and raise here.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs.base import LayerSpec
from repro_torch.models.attention import apply_self_attention, init_attention
from repro_torch.models.common import apply_ffn, apply_norm, init_ffn, init_norm
from repro_torch.models.recurrent import (
    apply_rglru,
    apply_rwkv_channelmix,
    apply_rwkv_timemix,
    init_rglru_block,
    init_rwkv_channelmix,
    init_rwkv_timemix,
)

_KINDS = ("attn", "local_attn", "rglru", "rwkv")


def _check_spec(spec: LayerSpec) -> None:
    if spec.kind not in _KINDS or spec.ffn != "dense":
        raise NotImplementedError(
            f"layer {spec.kind}/{spec.ffn} is not ported yet (dense "
            f"attn/local_attn/rglru/rwkv blocks only; see ROADMAP.md)"
        )


def init_block(generator, cfg, spec: LayerSpec, *, lead: Sequence[int] = (),
               device="cuda", dtype=torch.float32) -> Dict:
    _check_spec(spec)
    kw = dict(lead=lead, device=device, dtype=dtype)
    p: Dict = {"pre_norm": init_norm(cfg.norm, cfg.d_model, **kw)}
    if cfg.post_block_norm:
        p["post_mixer_norm"] = init_norm(cfg.norm, cfg.d_model, **kw)
        p["post_ffn_norm"] = init_norm(cfg.norm, cfg.d_model, **kw)
    if spec.kind == "rglru":
        p["mixer"] = init_rglru_block(generator, cfg, **kw)
    elif spec.kind == "rwkv":
        p["mixer"] = init_rwkv_timemix(generator, cfg, **kw)
    else:
        p["mixer"] = init_attention(generator, cfg, **kw)
    p["ffn_norm"] = init_norm(cfg.norm, cfg.d_model, **kw)
    if spec.kind == "rwkv":
        p["ffn"] = init_rwkv_channelmix(generator, cfg, **kw)
    else:
        p["ffn"] = init_ffn(generator, cfg, **kw)
    return p


def apply_block(p: Dict, x: torch.Tensor, *, cfg, spec: LayerSpec,
                causal: bool = True, attn_impl: Optional[str] = None,
                scan_impl: Optional[str] = None) -> torch.Tensor:
    _check_spec(spec)

    def norm(name, h):
        return apply_norm(p[name], h, cfg.norm)

    if spec.kind == "rglru":
        out = apply_rglru(p["mixer"], norm("pre_norm", x), cfg=cfg,
                          scan_impl=scan_impl)
    elif spec.kind == "rwkv":
        out = apply_rwkv_timemix(p["mixer"], norm("pre_norm", x), cfg=cfg,
                                 scan_impl=scan_impl)
    else:
        window = cfg.sliding_window if spec.kind == "local_attn" else 0
        out = apply_self_attention(p["mixer"], norm("pre_norm", x), cfg=cfg,
                                   window=window, causal=causal,
                                   attn_impl=attn_impl)
    if cfg.post_block_norm:
        out = norm("post_mixer_norm", out)
    x = x + out
    if spec.kind == "rwkv":
        out = apply_rwkv_channelmix(p["ffn"], norm("ffn_norm", x))
    else:
        out = apply_ffn(p["ffn"], norm("ffn_norm", x), cfg)
    if cfg.post_block_norm:
        out = norm("post_ffn_norm", out)
    return x + out
