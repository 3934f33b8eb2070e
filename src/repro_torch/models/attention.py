"""GQA self-attention, cross-attention and Multi-head Latent Attention of
the port, with the decode caches.

Port of ``repro/models/attention.py``.  ``apply_self_attention``: q/k/v
projections, optional per-head qk RMSNorm, RoPE at absolute positions
``pos + i``, then, without a cache, ``flash_attention`` with the layer's
window and the config's logit softcap.  With a cache (``make_kv_cache``)
the new K/V are written into it in place (the PyTorch counterpart of
JAX's functional update with a donated cache): a local layer's ring
buffer at ``(pos + i) % size`` (rounded to the ring's dtype, as JAX's
scatter rounds), then ``attention_reference`` over the ring's slots at
their absolute positions (JAX's ``_ring_attention``); a full cache at
``pos`` (of the compute dtype only, as JAX's ``dynamic_update_slice``
takes it), then ``attention_reference`` over the valid prefix
``kv_length`` (``pos + S`` when not given).  Both are plain PyTorch, as
both are plain jnp in JAX.  And of its cross-attention
(``init_cross_attention``, ``cross_kv``, ``apply_cross_attention``): the
queries attend, without a mask and without RoPE, to K/V projected from a
memory (the encoder's output or the stub frontend's embeddings), with an
optional ``tanh(gate)`` on the output (the VLM's gated block); and of
DeepSeek-V2's MLA train path (``init_mla``, ``_mla_q``, ``_mla_latent``
and ``apply_mla``'s expanded branch): q through a low-rank down / up
projection with ``q_norm``, K and V expanded from the normed latent
``ckv``, RoPE on the q_rope half and on the one k_rope shared by every
head, then ``flash_attention`` at d_qk = qk_nope + qk_rope over
d_v = v_head_dim; with a latent cache (``make_mla_cache``) the absorbed
decode: ``ckv`` and the rotated ``k_rope`` written at ``pos``, ``W_uk``
absorbed into q, the scores from the cached latent and rope key at scale
1/sqrt(qk_nope + qk_rope), and ``W_uv`` applied after the softmax, never
expanding K or V; one ``kv_length`` for the batch, as JAX's takes.  Layout [B, S, H, D] throughout.
With a ``ModelParallel`` (``sharding/tp.py``) the train path of the
self-attention (``_tp_self_attention``) and the cross-attention run
tensor-parallel over the 'model' axis, as JAX's constraints over 'heads'
/ 'kv' have XLA run them: each rank attends with its q heads over the kv
heads they read and multiplies by its rows of ``wo`` (``_tp_attend``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.flash_attention import (
    attention_reference,
    flash_attention,
)
from repro_torch.kernels.flash_attention.ops import NEG_INF
from repro_torch.models.common import (
    apply_rope,
    dense_init,
    matmul,
    rms_norm_per_head,
    tp_columns,
)
from repro_torch.sharding.tp import copy_in, covering, owned_part, reduce_out


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
    q = matmul(x, p["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = matmul(x, p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = matmul(x, p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.use_qk_norm:
        q = rms_norm_per_head(q, p["q_norm"])
        k = rms_norm_per_head(k, p["k_norm"])
    return q, k, v


def _tp_heads(cfg, tp) -> Tuple[int, int, int, int, int, int]:
    """``(o0, o1, h0, h1, k0, k1)``: the attention output columns
    ``[o0, o1)`` this rank owns (its rows of ``wo``: its shard where
    'heads' splits, else its share of whole heads; all of them without
    ``tp``), the q heads ``[h0, h1)`` that cover them and the kv heads
    ``[k0, k1)`` those read."""
    group = cfg.n_heads // cfg.n_kv_heads
    o0, o1, h0, h1 = covering(tp, "heads",
                              cfg.n_heads * cfg.resolved_head_dim,
                              cfg.resolved_head_dim)
    return o0, o1, h0, h1, h0 // group, (h1 - 1) // group + 1


def _tp_attend(p, q, k, v, heads, *, cfg, causal: bool, window: int,
               attn_impl: Optional[str], tp) -> torch.Tensor:
    """The flash over this rank's q heads ``[h0, h1)`` [B, S, h1 - h0, D]
    and kv heads ``[k0, k1)`` [B, Sk, k1 - k0, D] (``_tp_heads``): a local
    q head ``h`` reads local kv head ``h // (H / KV)`` where the slices
    line up (each kv head's whole group on one rank), an explicit map
    otherwise.  Then this rank's output columns times its rows of ``wo``,
    the partial sum all-reduced over 'model'."""
    o0, o1, h0, h1, k0, k1 = heads
    b, s = q.shape[:2]
    hd = cfg.resolved_head_dim
    group = cfg.n_heads // cfg.n_kv_heads
    reads = [(h0 + i) // group - k0 for i in range(h1 - h0)]
    if (h1 - h0) % (k1 - k0) or reads != [
            i // ((h1 - h0) // (k1 - k0)) for i in range(h1 - h0)]:
        idx = torch.tensor(reads, device=q.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    att = flash_attention(q, k, v, causal=causal, window=window,
                          softcap=cfg.attn_logit_softcap, impl=attn_impl)
    att = att.reshape(b, s, -1)[..., o0 - h0 * hd:o1 - h0 * hd]
    wo = owned_part(p["wo"], "heads", cfg.n_heads * hd, o0, o1, tp)
    return reduce_out(matmul(att, wo), tp)


def _tp_self_attention(p, x, *, cfg, window: int, causal: bool, pos: int,
                       attn_impl: Optional[str], tp) -> torch.Tensor:
    """Self-attention over the heads this rank owns, row-parallel out
    (``_tp_attend``).  Projections split inside a head are gathered
    (``tp_columns``); ``q_norm`` / ``k_norm`` meet this rank's heads
    only, so they go in through ``copy_in``."""
    b, s, _ = x.shape
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    heads = _tp_heads(cfg, tp)
    _, _, h0, h1, k0, k1 = heads
    xc = copy_in(x, tp)
    q = tp_columns(xc, p["wq"], "heads", cfg.n_heads * hd, h0 * hd, h1 * hd,
                   tp)
    k = tp_columns(xc, p["wk"], "kv", kv * hd, k0 * hd, k1 * hd, tp)
    v = tp_columns(xc, p["wv"], "kv", kv * hd, k0 * hd, k1 * hd, tp)
    q = q.reshape(b, s, h1 - h0, hd)
    k = k.reshape(b, s, k1 - k0, hd)
    v = v.reshape(b, s, k1 - k0, hd)
    if cfg.use_qk_norm:
        q = rms_norm_per_head(q, copy_in(p["q_norm"], tp))
        k = rms_norm_per_head(k, copy_in(p["k_norm"], tp))
    qpos = pos + torch.arange(s, device=x.device)
    q = apply_rope(q, qpos, cfg.rope_theta)
    k = apply_rope(k, qpos, cfg.rope_theta)
    return _tp_attend(p, q, k, v, heads, cfg=cfg, causal=causal,
                      window=window, attn_impl=attn_impl, tp=tp)


def make_kv_cache(cfg, batch: int, max_len: int, window: int = 0, *,
                  lead: Sequence[int] = (), device="cuda",
                  dtype=torch.float32, prefill_chunk: int = 1) -> Dict:
    """window > 0 -> ring buffer.  The ring must hold ``window +
    prefill_chunk - 1`` positions so a chunked prefill never clobbers keys
    still visible to queries in the same chunk; decode (chunk=1) needs
    exactly ``window``.  Small contexts (max_len <= that) fall back to a
    plain full cache."""
    size = min(max_len, window + prefill_chunk - 1) if window else max_len
    shape = (*lead, batch, size, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _write_at(cache: torch.Tensor, pos: int, new: torch.Tensor) -> None:
    """``cache[:, pos:pos + S] = new``, refused across dtypes as JAX's
    ``dynamic_update_slice`` refuses them (a ring's write rounds)."""
    if cache.dtype != new.dtype:
        raise TypeError(f"a cache write needs the cache's dtype: cache "
                        f"{cache.dtype}, update {new.dtype}")
    cache[:, pos:pos + new.shape[1]] = new


def _full_length(kv_length: Optional[torch.Tensor], end: int, b: int,
                 device) -> torch.Tensor:
    """The valid key prefix [B]: ``kv_length``, else ``end`` for every row."""
    if kv_length is not None:
        return torch.broadcast_to(kv_length.to(device), (b,))
    return torch.full((b,), end, dtype=torch.long, device=device)


def ring_positions(pos: int, s: int, size: int, device
                   ) -> Tuple[torch.Tensor, int]:
    """After ``s`` positions from ``pos`` went into a ring of ``size``
    slots: the absolute position each slot holds (the largest p <= the
    newest with p % size == slot) and the oldest retained position."""
    newest = pos + s - 1
    slot = torch.arange(size, device=device)
    return newest - ((newest - slot) % size), max(newest - size + 1, 0)


def apply_self_attention(p: Dict, x: torch.Tensor, *, cfg, window: int = 0,
                         causal: bool = True, pos: int = 0,
                         cache: Optional[Dict] = None,
                         kv_length: Optional[torch.Tensor] = None,
                         attn_impl: Optional[str] = None,
                         tp=None) -> torch.Tensor:
    """x [B, S, d] at absolute positions ``pos``.. -> [B, S, d]; ``cache``
    (``make_kv_cache``) is written in place.  ``tp`` (a
    ``ModelParallel``) runs it over this rank's heads
    (``_tp_self_attention``), without a cache."""
    if tp is not None:
        if cache is not None:
            raise NotImplementedError(
                "a KV cache sharded over the 'model' axis (JAX's "
                "cache_specs) is not ported: ROADMAP item 8.4")
        return _tp_self_attention(p, x, cfg=cfg, window=window,
                                  causal=causal, pos=pos,
                                  attn_impl=attn_impl, tp=tp)
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    qpos = pos + torch.arange(s, device=x.device)
    q = apply_rope(q, qpos, cfg.rope_theta)
    k = apply_rope(k, qpos, cfg.rope_theta)
    if cache is None:
        att = flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cfg.attn_logit_softcap, impl=attn_impl)
        return matmul(att.reshape(b, s, -1), p["wo"])
    ck, cv = cache["k"], cache["v"]
    size = ck.shape[1]
    if window:
        if pos + s > size and size < window + s - 1:
            raise ValueError(
                f"ring cache ({size}) too small for window={window} with "
                f"chunk={s}; init it with prefill_chunk>={s}")
        # ring buffer write at pos % size
        idx = qpos % size
        ck.index_copy_(1, idx, k.to(ck.dtype))
        cv.index_copy_(1, idx, v.to(cv.dtype))
        slot_pos, oldest = ring_positions(pos, s, size, x.device)
        att = attention_reference(
            q, ck, cv, window=window, softcap=cfg.attn_logit_softcap,
            q_offset=pos, k_pos=slot_pos, oldest=oldest)
    else:
        _write_at(ck, pos, k)
        _write_at(cv, pos, v)
        att = attention_reference(
            q, ck, cv, causal=causal, softcap=cfg.attn_logit_softcap,
            q_offset=pos,
            kv_length=_full_length(kv_length, pos + s, b, x.device))
    return matmul(att.reshape(b, s, -1), p["wo"])


def init_cross_attention(generator, cfg, *, lead: Sequence[int] = (),
                         device="cuda", dtype=torch.float32) -> Dict:
    """``init_attention``'s params plus the 0-d ``gate`` (0: closed)."""
    p = init_attention(generator, cfg, lead=lead, device=device, dtype=dtype)
    p["gate"] = torch.zeros(tuple(lead), dtype=dtype, device=device)
    return p


def cross_kv(p: Dict, memory: torch.Tensor, cfg, tp=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """memory [B, M, d] -> K, V [B, M, KV, D] (K per-head normed with
    ``use_qk_norm``), in the promoted dtype of the memory and the weights:
    f32 for the f32 stub memory (or an encoder's output over it) under
    bf16 params, as JAX never casts the memory.  With ``tp`` (a
    ``ModelParallel``) the kv heads ``[k0, k1)`` this rank's q heads read
    (``_tp_heads``), from its columns of ``wk`` / ``wv`` (gathered where a
    head straddles ranks).  The memory goes in as it is: its gradient
    here covers this rank's heads only, and ``model.encode`` sums it over
    'model' once for every cross layer."""
    b, m, _ = memory.shape
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    _, _, _, _, k0, k1 = _tp_heads(cfg, tp)
    k = tp_columns(memory, p["wk"], "kv", kv * hd, k0 * hd, k1 * hd,
                   tp).reshape(b, m, k1 - k0, hd)
    v = tp_columns(memory, p["wv"], "kv", kv * hd, k0 * hd, k1 * hd,
                   tp).reshape(b, m, k1 - k0, hd)
    if cfg.use_qk_norm:
        k = rms_norm_per_head(k, copy_in(p["k_norm"], tp))
    return k, v


def apply_cross_attention(p: Dict, x: torch.Tensor,
                          kv: Tuple[torch.Tensor, torch.Tensor], *, cfg,
                          gated: bool = False,
                          attn_impl: Optional[str] = None,
                          tp=None) -> torch.Tensor:
    """x [B, S, d] attends to ``kv`` (``cross_kv``) -> [B, S, d] in x's
    promoted dtype: a bf16 decoder's queries over f32 K/V attend in f32
    and come back bf16 (``flash_attention``'s promotion), as in JAX.
    With ``tp`` (a ``ModelParallel``) over this rank's q heads and the kv
    heads ``cross_kv(tp=tp)`` gave, row-parallel out (``_tp_attend``);
    without it the same body over every head."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    k, v = kv
    heads = _tp_heads(cfg, tp)
    _, _, h0, h1, _, _ = heads
    q = tp_columns(copy_in(x, tp), p["wq"], "heads", cfg.n_heads * hd,
                   h0 * hd, h1 * hd, tp).reshape(b, s, h1 - h0, hd)
    if cfg.use_qk_norm:
        q = rms_norm_per_head(q, copy_in(p["q_norm"], tp))
    out = _tp_attend(p, q, k, v, heads, cfg=cfg, causal=False, window=0,
                     attn_impl=attn_impl, tp=tp)
    if gated:
        out = torch.tanh(p["gate"].float()).to(out.dtype) * out
    return out


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V2)
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


def make_mla_cache(cfg, batch: int, max_len: int, *,
                   lead: Sequence[int] = (), device="cuda",
                   dtype=torch.float32) -> Dict:
    """The latent cache: ``ckv`` [B, S_max, kv_lora], ``krope`` [B, S_max,
    qk_rope]."""
    m = cfg.mla
    return {
        "ckv": torch.zeros((*lead, batch, max_len, m.kv_lora_rank),
                           dtype=dtype, device=device),
        "krope": torch.zeros((*lead, batch, max_len, m.qk_rope_head_dim),
                             dtype=dtype, device=device),
    }


def apply_mla(p: Dict, x: torch.Tensor, *, cfg, pos: int = 0,
              cache: Optional[Dict] = None,
              kv_length: Optional[torch.Tensor] = None,
              attn_impl: Optional[str] = None) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d], causal.  Without a cache, K/V expanded from
    the latent; with one (``make_mla_cache``, written in place), the
    absorbed matmuls against it."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    qpos = pos + torch.arange(s, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, qpos)
    ckv, k_rope = _mla_latent(p, x, cfg, qpos)
    if cache is None:
        k_nope = (ckv @ p["wuk"]).reshape(b, s, h, m.qk_nope_head_dim)
        vv = (ckv @ p["wuv"]).reshape(b, s, h, m.v_head_dim)
        k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            b, s, h, m.qk_rope_head_dim)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        att = flash_attention(q_full, k_full, vv, causal=True, impl=attn_impl)
        return att.reshape(b, s, -1) @ p["wo"]

    # absorbed decode path
    if kv_length is not None and kv_length.numel() > 1:
        # JAX's masks with the lengths against the key axis, so a [B]
        # kv_length at B > 1 fails there; the port takes one length too
        raise ValueError(f"MLA's absorbed decode takes one kv_length for "
                         f"the batch, got {tuple(kv_length.shape)}")
    cckv, ckrope = cache["ckv"], cache["krope"]
    _write_at(cckv, pos, ckv)
    _write_at(ckrope, pos, k_rope)
    length = _full_length(kv_length, pos + s, b, x.device)
    smax = cckv.shape[1]
    # absorb W_uk into q: q_lat [b, s, h, kv_lora]
    wuk = p["wuk"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim)
    q_lat = torch.einsum("bshd,lhd->bshl", q_nope, wuk)
    scale = 1.0 / torch.sqrt(torch.tensor(
        float(m.qk_nope_head_dim + m.qk_rope_head_dim), dtype=torch.float32,
        device=x.device))
    scores = (
        torch.einsum("bshl,bkl->bhsk", q_lat.float(), cckv.float())
        + torch.einsum("bshd,bkd->bhsk", q_rope.float(), ckrope.float())
    ) * scale
    kpos_all = torch.arange(smax, device=x.device)
    valid = ((kpos_all[None, None, :] <= qpos[None, :, None])
             & (kpos_all[None, None, :] < length[:, None, None]))  # [B,S,K]
    scores = torch.where(valid[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out_lat = torch.einsum("bhsk,bkl->bshl", probs, cckv.float())
    wuv = p["wuv"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    att = torch.einsum("bshl,lhd->bshd", out_lat, wuv.float()).to(x.dtype)
    return att.reshape(b, s, -1) @ p["wo"]
