"""Decoder and encoder block of the port: (norm -> sequence mixer ->
residual) -> (norm -> FFN -> residual), with gemma2-style post-norms when
``cfg.post_block_norm``.

Port of ``repro/models/blocks.py`` (train path) for every kind: GQA
self-attention (``attn``, ``local_attn`` with its window), DeepSeek-V2's
latent attention (``mla``), the RG-LRU recurrent block (``rglru``), the
cross-attention kind (``cross_attn``) and the RWKV-6 block (``rwkv``),
whose mixer is the time-mix and whose FFN sublayer is the RWKV
channel-mix (token-shifted squared-relu MLP).  A ``cross_attn`` block is,
in an encoder-decoder, causal self-attention, then a ``cross_norm`` ->
cross-attention sublayer over the encoder's output, then the FFN; in a
VLM, the gated cross-attention over the stub frontend's embeddings is its
mixer.  The FFN is dense (``cfg.d_ff`` wide) or, for ``ffn="moe"``, the
capacity-dispatched MoE, whose load-balance aux loss ``apply_block``
returns beside x (0 for a dense block, as JAX's ``(x, cache, aux)``
gives).

Decode: ``init_block_cache`` builds a block's cache in JAX's tree (``kv``
for the self-attention kinds, MLA's latent cache under ``kv`` too, an
enc-dec decoder block's own ``kv`` beside its ``cross_k`` / ``cross_v``, a
VLM block's ``cross_k`` / ``cross_v``, the recurrent kinds' ``state``),
and ``apply_block`` given a cache, the absolute position ``pos`` and an
optional ``kv_length`` threads it into the mixers, which write it in
place.  A cross-attention's K/V come from the memory when one is given
(stored into the cache with ``fill_cross_cache``, at prefill) and from
the cache otherwise (decode).

Over the 'model' mesh axis (a ``ModelParallel``, ``sharding/tp.py``)
every block kind runs tensor-parallel on its train path: attention,
cross-attention (the VLM's gated block too) and MLA over this rank's
heads, the RG-LRU over its 'lru' channels, RWKV-6's time-mix over its
heads and channel-mix over its ff columns, the FFN over its ff columns,
MoE over its experts (the shared experts over their ff columns), norms
replicated.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import LayerSpec
from repro_torch.models.attention import (
    apply_cross_attention,
    apply_mla,
    apply_self_attention,
    cross_kv,
    init_attention,
    init_cross_attention,
    init_mla,
    make_kv_cache,
    make_mla_cache,
)
from repro_torch.models.common import apply_ffn, apply_norm, init_ffn, init_norm
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.models.recurrent import (
    apply_rglru,
    apply_rwkv_channelmix,
    apply_rwkv_timemix,
    init_rglru_block,
    init_rwkv_channelmix,
    init_rwkv_timemix,
    make_rglru_state,
    make_rwkv_state,
)


_KINDS = ("attn", "local_attn", "mla", "rglru", "rwkv", "cross_attn")


def _check_spec(spec: LayerSpec) -> None:
    if spec.kind not in _KINDS or spec.ffn not in ("dense", "moe"):
        raise ValueError(f"unknown layer {spec.kind}/{spec.ffn}")


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
    elif spec.kind == "mla":
        p["mixer"] = init_mla(generator, cfg, **kw)
    elif spec.kind == "cross_attn" and cfg.is_encoder_decoder:
        p["mixer"] = init_attention(generator, cfg, **kw)          # self
        p["cross"] = init_cross_attention(generator, cfg, **kw)
        p["cross_norm"] = init_norm(cfg.norm, cfg.d_model, **kw)
    elif spec.kind == "cross_attn":          # VLM gated cross block
        p["mixer"] = init_cross_attention(generator, cfg, **kw)
    else:
        p["mixer"] = init_attention(generator, cfg, **kw)
    p["ffn_norm"] = init_norm(cfg.norm, cfg.d_model, **kw)
    if spec.kind == "rwkv":
        p["ffn"] = init_rwkv_channelmix(generator, cfg, **kw)
    elif spec.ffn == "moe":
        p["ffn"] = init_moe(generator, cfg, **kw)
    else:
        p["ffn"] = init_ffn(generator, cfg, **kw)
    return p


def init_block_cache(cfg, spec: LayerSpec, batch: int, max_len: int, *,
                     lead: Sequence[int] = (), device="cuda",
                     dtype=torch.float32, prefill_chunk: int = 1) -> Dict:
    _check_spec(spec)
    kw = dict(lead=lead, device=device, dtype=dtype)
    c: Dict = {}
    if spec.kind == "attn":
        c["kv"] = make_kv_cache(cfg, batch, max_len, **kw)
    elif spec.kind == "local_attn":
        c["kv"] = make_kv_cache(cfg, batch, max_len,
                                window=cfg.sliding_window,
                                prefill_chunk=prefill_chunk, **kw)
    elif spec.kind == "mla":
        c["kv"] = make_mla_cache(cfg, batch, max_len, **kw)
    elif spec.kind == "cross_attn":
        if cfg.is_encoder_decoder:
            c["kv"] = make_kv_cache(cfg, batch, max_len, **kw)
        shape = (*lead, batch, max(cfg.n_modal_tokens, 1), cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        c["cross_k"] = torch.zeros(shape, device=device, dtype=dtype)
        c["cross_v"] = torch.zeros(shape, device=device, dtype=dtype)
    elif spec.kind == "rglru":
        c["state"] = make_rglru_state(cfg, batch, **kw)
    elif spec.kind == "rwkv":
        c["state"] = make_rwkv_state(cfg, batch, **kw)
    return c


def apply_block(p: Dict, x: torch.Tensor, *, cfg, spec: LayerSpec,
                memory: Optional[torch.Tensor] = None, causal: bool = True,
                pos: int = 0, cache: Optional[Dict] = None,
                kv_length: Optional[torch.Tensor] = None,
                fill_cross_cache: bool = False,
                capacity_factor: float = 1.25,
                attn_impl: Optional[str] = None,
                scan_impl: Optional[str] = None, tp=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (x [B, S, d], the MoE aux loss, an f32 0-d tensor);
    a ``cross_attn`` block attends to ``memory`` [B, M, d] or, without
    it, to the K/V its ``cache`` holds.  ``cache`` (``init_block_cache``)
    is written in place.  ``tp`` (a ``ModelParallel``) runs the block
    tensor-parallel over the 'model' axis, without a cache; an
    encoder-decoder's cross-attention ``memory`` is then the encoder's
    output as ``model.encode`` gives it with ``tp``."""
    _check_spec(spec)
    if spec.kind == "cross_attn" and memory is None and cache is None:
        raise ValueError("a cross_attn block needs the memory or a filled "
                         "cache")

    def norm(name, h):
        return apply_norm(p[name], h, cfg.norm)

    def cross(mixer_p):
        """Cross-attention K/V: from the memory at train / prefill (stored
        with ``fill_cross_cache``), from the cache at decode."""
        if memory is not None:
            k, v = cross_kv(mixer_p, memory, cfg, tp=tp)
            if cache is not None and fill_cross_cache:
                cache["cross_k"].copy_(k)
                cache["cross_v"].copy_(v)
            return k, v
        return cache["cross_k"], cache["cross_v"]

    attn_kw = dict(pos=pos, cache=cache.get("kv") if cache else None,
                   kv_length=kv_length, attn_impl=attn_impl)
    state = cache.get("state") if cache else None
    if spec.kind == "rglru":
        out = apply_rglru(p["mixer"], norm("pre_norm", x), cfg=cfg,
                          state=state, scan_impl=scan_impl, tp=tp)
    elif spec.kind == "rwkv":
        out = apply_rwkv_timemix(p["mixer"], norm("pre_norm", x), cfg=cfg,
                                 state=state, scan_impl=scan_impl, tp=tp)
    elif spec.kind == "mla":
        out = apply_mla(p["mixer"], norm("pre_norm", x), cfg=cfg, tp=tp,
                        **attn_kw)
    elif spec.kind == "cross_attn" and not cfg.is_encoder_decoder:
        out = apply_cross_attention(
            p["mixer"], norm("pre_norm", x), cross(p["mixer"]), cfg=cfg,
            gated=True, attn_impl=attn_impl, tp=tp)
    else:
        window = cfg.sliding_window if spec.kind == "local_attn" else 0
        out = apply_self_attention(p["mixer"], norm("pre_norm", x), cfg=cfg,
                                   window=window, causal=causal, tp=tp,
                                   **attn_kw)
    if cfg.post_block_norm:
        out = norm("post_mixer_norm", out)
    x = x + out
    if spec.kind == "cross_attn" and cfg.is_encoder_decoder:
        x = x + apply_cross_attention(
            p["cross"], norm("cross_norm", x), cross(p["cross"]), cfg=cfg,
            attn_impl=attn_impl, tp=tp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.kind == "rwkv":
        out = apply_rwkv_channelmix(p["ffn"], norm("ffn_norm", x), cfg=cfg,
                                    state=state, tp=tp)
    elif spec.ffn == "moe":
        out, aux = apply_moe(p["ffn"], norm("ffn_norm", x), cfg=cfg,
                             capacity_factor=capacity_factor, tp=tp)
    else:
        out = apply_ffn(p["ffn"], norm("ffn_norm", x), cfg, tp=tp)
    if cfg.post_block_norm:
        out = norm("post_ffn_norm", out)
    return x + out, aux
