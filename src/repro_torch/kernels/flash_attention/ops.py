"""Attention entry point of the port: CUDA forward kernel + recompute
backward, as one ``torch.autograd.Function``.

Layout (the JAX package's, kept at the public function): q [B, Sq, H, D],
k [B, Sk, KV, D], v [B, Sk, KV, DV] and out [B, Sq, H, DV]; GQA maps head h
to kv head h // (H // KV).  DV may differ from D (MLA: d_qk 192 over d_v
128); the scale is 1/sqrt(D) either way.

* Forward on a CUDA tensor: ``flash_fwd_cuda`` launches a hand-written
  Hopper kernel replacing the Pallas ``flash_attention_pallas`` and
  returns (out, lse): on f32 inputs the split-TF32 tensor-core kernel of
  csrc/flash_fwd.cu (a split pass writes K and V as TF32 hi + lo into
  scratch, ``flash_split_plain`` is its plain version; both products run
  as three TF32 wgmmas, hi.hi + hi.lo + lo.hi), on bf16 inputs the
  tensor-core kernel of csrc/flash_fwd_sm90.cu (TMA, wgmma, P.V with P
  split into two bf16 terms).  On a CPU tensor the plain version
  ``flash_fwd_plain`` runs instead; on a CUDA tensor the plain version
  runs only when the caller asks for it by name (``impl="plain"``, used to
  hold the kernels against it).  q/k/v are f32 or bf16: every version
  accumulates in f32 and writes the output in q's dtype, with lse in f32,
  as the Pallas kernel does.  Both kernels take the (d_qk, d_v) pairs of
  ``KERNEL_DIMS`` and zero-pad any other to one of them (``kernel_dims``).
  ``flash_attention`` given mixed dtypes computes as JAX's promotion does:
  all three in the widest dtype (a bf16 q over an f32 memory's K/V runs
  the f32 kernel), the output back in q's dtype, and each gradient in its
  input's dtype, through the casts' own backward.
* Backward: ``flash_bwd_plain`` — the PyTorch counterpart of the JAX
  package's ``flash.py::_global_bwd`` / ``_local_bwd`` (the TPU kernel
  has no backward; JAX differentiates that plain-jnp code).  It
  recomputes the scores from lse block by block, with
  ``delta = rowsum(dO * O)`` and the ``1 - t^2`` softcap factor, in
  O(S * block) memory.  Its gradients come back in the inputs' dtypes,
  as ``jax.grad`` of ``flash.py`` gives them.

Both plain functions walk query blocks over the visible kv span
[max(0, q0 - window + 1), min(Sk, q1)) — the structural skip the kernel
makes with its loop bounds.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_BLOCK_Q = 512
# the (d_qk, d_v) pairs both kernels instantiate: the square head dims and
# MLA's two (192 / 128, and 64 / 32 for the smoke 48 / 32)
KERNEL_DIMS = ((32, 32), (64, 64), (128, 128), (256, 256), (192, 128),
               (64, 32))


def kernel_dims(d: int, dv: int) -> Tuple[int, int]:
    """The (d_qk, d_v) either kernel runs a call of head dims (d, dv) at:
    its own pair when instantiated, else the smallest instantiated pair
    that holds it, which the call is zero-padded to (smoke-size MLA's 48 /
    32 runs at 64 / 32)."""
    fits = [p for p in KERNEL_DIMS if p[0] >= d and p[1] >= dv]
    if not fits:
        raise ValueError(f"no flash instantiation holds head dims "
                         f"{d} / {dv} (instantiated: {KERNEL_DIMS})")
    return min(fits, key=lambda p: (p[0] + p[1], p))


def _span(q0: int, q1: int, sk: int, causal: bool, window: int) -> Tuple[int, int]:
    lo = max(0, q0 - window + 1) if window else 0
    hi = min(sk, q1) if causal else sk
    return lo, hi


def _mask(q0, q1, lo, hi, causal, window, device):
    qpos = torch.arange(q0, q1, device=device)[:, None]
    kpos = torch.arange(lo, hi, device=device)[None, :]
    m = torch.ones((q1 - q0, hi - lo), dtype=torch.bool, device=device)
    if causal:
        m = m & (kpos <= qpos)
    if window:
        m = m & (kpos > qpos - window)
    return m  # [bq, span]


def _fold(x: torch.Tensor, kvh: int) -> torch.Tensor:
    """[B, S, H, D] -> [B, S, KVH, G, D]."""
    b, s, h, d = x.shape
    return x.reshape(b, s, kvh, h // kvh, d)


def _inv_sqrt(d: int, device) -> torch.Tensor:
    return 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32,
                                         device=device))


def flash_fwd_plain(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, block_q: int = _BLOCK_Q):
    """Plain PyTorch forward: (out [B,Sq,H,DV], lse [B,H,Sq] f32)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    q5 = _fold(q, kvh).float() / torch.sqrt(
        torch.tensor(float(d), dtype=torch.float32, device=q.device))
    kf, vf = k.float(), v.float()
    out = torch.empty((b, sq, kvh, g, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    lse = torch.empty((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, block_q):
        q1 = min(q0 + block_q, sq)
        lo, hi = _span(q0, q1, sk, causal, window)
        s = torch.einsum("bqhgd,bkhd->bhgqk", q5[:, q0:q1], kf[:, lo:hi])
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        mask = _mask(q0, q1, lo, hi, causal, window, q.device)
        s = torch.where(mask, s, NEG_INF)
        m = torch.amax(s, dim=-1)
        p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
        l_safe = torch.clamp(torch.sum(p, dim=-1), min=1e-30)
        acc = torch.einsum("bhgqk,bkhd->bqhgd", p, vf[:, lo:hi])
        out[:, q0:q1] = acc / l_safe.permute(0, 3, 1, 2)[..., None]
        lse[..., q0:q1] = m + torch.log(l_safe)
    return (out.reshape(b, sq, h, -1).to(q.dtype),
            lse.reshape(b, h, sq))


def flash_bwd_plain(q, k, v, out, lse, dout, *, causal: bool = True,
                    window: int = 0, softcap: float = 0.0,
                    block_q: int = _BLOCK_Q):
    """Recompute backward from lse: (dq, dk, dv)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = _inv_sqrt(d, q.device)
    q5 = _fold(q, kvh).float() * scale
    g5 = _fold(dout, kvh).float()
    o5 = _fold(out, kvh).float()
    lse5 = lse.reshape(b, kvh, g, sq)
    delta = torch.einsum("bqhgd,bqhgd->bhgq", g5, o5)
    kf, vf = k.float(), v.float()
    dq = torch.empty_like(q5)
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(vf.shape, dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, block_q):
        q1 = min(q0 + block_q, sq)
        lo, hi = _span(q0, q1, sk, causal, window)
        qb, gb = q5[:, q0:q1], g5[:, q0:q1]
        kb, vb = kf[:, lo:hi], vf[:, lo:hi]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb)
        t = None
        if softcap:
            t = torch.tanh(s / softcap)
            s = softcap * t
        mask = _mask(q0, q1, lo, hi, causal, window, q.device)
        p = torch.where(mask, torch.exp(s - lse5[..., q0:q1, None]), 0.0)
        dv[:, lo:hi] += torch.einsum("bhgqk,bqhgd->bkhd", p, gb)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", gb, vb)
        ds = p * (dp - delta[..., q0:q1, None])
        if softcap:
            ds = ds * (1.0 - t * t)
        dq[:, q0:q1] = torch.einsum("bhgqk,bkhd->bqhgd", ds, kb) * scale
        dk[:, lo:hi] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qb)
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# The f32 kernel's split pass (csrc/flash_fwd.cu, flash_split_kernel).  Its
# scratch holds, for each (batch, kv head) and block of SPLIT_BK keys (zero
# past Sk), K's D / dc stages then V's DV / dc, each stage a hi half then a lo
# half of SPLIT_BK * dc floats, dc = min(D, DV, 64): K's stage c is keys x
# d-columns [c dc, (c + 1) dc), V's is d-rows [c dc, (c + 1) dc) x keys,
# transposed, with the keys of each group of 8 in the order SPLIT_KEY_ORDER.
# A half is column chunks of 32 floats (K: the stage's d-columns; V: its 64
# key positions), each chunk its rows of 128 bytes in the 128-byte swizzle:
# the 16-byte unit u of row r sits at unit u ^ (r % 8).
SPLIT_BK = 64
SPLIT_KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 ``x`` rounded to 10 mantissa bits, to
    nearest with ties away from zero (the low 13 bits of the result are 0)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_shape(b: int, kvh: int, sk: int, d: int,
                dv: Optional[int] = None) -> Tuple[int, ...]:
    """[B * KVH, key blocks, K's stages then V's, (hi, lo), SPLIT_BK * dc]
    (``dv`` None means DV = D)."""
    dv = d if dv is None else dv
    dc = min(d, dv, 64)
    return (b * kvh, -(-sk // SPLIT_BK), d // dc + dv // dc, 2, SPLIT_BK * dc)


def split_buffer(b: int, kvh: int, sk: int, d: int, device,
                 dv: Optional[int] = None) -> torch.Tensor:
    """Scratch for the f32 kernel's split pass (at the kernel's head dims,
    ``kernel_dims``)."""
    return torch.empty(split_shape(b, kvh, sk, d, dv), dtype=torch.float32,
                       device=device)


def _swizzled(t: torch.Tensor) -> torch.Tensor:
    """[..., R, W] -> [..., W * R]: W / 32 column chunks, each R rows of 32
    in the 128-byte swizzle (an involution on each row's 16-byte units)."""
    *lead, rows, w = t.shape
    t = t.reshape(*lead, rows, w // 32, 32).transpose(-3, -2)
    r = torch.arange(rows, device=t.device)[:, None]
    c = torch.arange(32, device=t.device)[None, :]
    idx = (((c // 4) ^ (r % 8)) * 4 + c % 4).expand_as(t)
    return torch.gather(t, -1, idx).reshape(*lead, w * rows)


def flash_split_plain(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of the f32 kernel's split pass: K [B, Sk, KV, D] and V
    [B, Sk, KV, DV] -> the scratch ``split_shape`` describes, bit for bit."""
    b, sk, kvh, d = k.shape
    dv = v.shape[-1]
    dc = min(d, dv, 64)
    nkb = -(-sk // SPLIT_BK)
    pad = nkb * SPLIT_BK - sk

    def blocks(x):                     # [B * KVH, key blocks, SPLIT_BK, width]
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
        return x.permute(0, 2, 1, 3).reshape(b * kvh, nkb, SPLIT_BK, -1)

    order = torch.tensor([8 * (i // 8) + SPLIT_KEY_ORDER[i % 8]
                          for i in range(SPLIT_BK)], device=k.device)
    kt = blocks(k).reshape(b * kvh, nkb, SPLIT_BK, d // dc, dc).transpose(2, 3)
    vt = blocks(v)[:, :, order].reshape(b * kvh, nkb, SPLIT_BK, dv // dc, dc)
    vt = vt.permute(0, 1, 3, 4, 2)     # [.., stage, d-row, key position]
    parts = []
    for t in (kt, vt):
        hi = tf32_round(t)
        lo = tf32_round(t - hi)
        parts.append(torch.stack([_swizzled(hi), _swizzled(lo)], dim=3))
    return torch.cat(parts, dim=2)


def _row_aligned(x: torch.Tensor) -> bool:
    """Rows of four-element chunks the f32 kernel can load whole."""
    return (x.stride(-1) == 1 and x.data_ptr() % (4 * x.element_size()) == 0
            and all(s % 4 == 0 for s in x.stride()[:-1]))


def _tma_strides(x: torch.Tensor) -> Tuple[int, int, int]:
    """x's (batch, seq, head) element strides for a TMA tensor map.  A
    dimension of size 1 is never stepped along, so it takes the stride a
    contiguous tensor would have."""
    b, s, h, d = x.shape
    canonical = (s * h * d, h * d, d)
    return tuple(st if n > 1 else c for st, n, c
                 in zip(x.stride()[:3], x.shape[:3], canonical))


def _tma_aligned(x: torch.Tensor) -> bool:
    """A bf16 [B, S, H, D] tensor TMA can load: unit head-dim stride, a
    16-byte-aligned base and every other stride a multiple of 16 bytes."""
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(st % 8 == 0 for st in _tma_strides(x)))


def bf16_reads_unpadded(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether the bf16 kernel reads q and k at their own head dim: both
    bf16 with strides TMA can take, so a head dim below the instantiated
    one needs no zero-padded copies (its tensor maps fill the rest of each
    tile with zeros)."""
    return (q.dtype == k.dtype == torch.bfloat16 and _tma_aligned(q)
            and _tma_aligned(k))


_ENTRY = {torch.float32: ("flash_fwd", "flash_fwd_f32"),
          torch.bfloat16: ("flash_fwd_sm90", "flash_fwd_sm90_bf16")}
# the two entry points' parameters: q, k, v, o, lse (and the f32 kernel's
# split scratch), B, H, KVH, Sq, Sk, D, DV, the twelve strides, causal,
# window, softcap, sm_scale, device, stream
_TAIL = ([ctypes.c_longlong] * 12
         + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p])
F32_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + _TAIL
BF16_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + _TAIL


def flash_fwd_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                   softcap: float = 0.0, split: Optional[torch.Tensor] = None):
    """Launch the Hopper forward kernel of q's dtype: (out [B,Sq,H,DV],
    lse [B,H,Sq]).  q, k and v share one dtype (``flash_attention``
    promotes mixed ones).  Needs at least one key.

    A (D, DV) pair the kernel does not instantiate runs at
    ``kernel_dims(D, DV)``: v is zero-padded to its d_v and out comes back
    sliced to DV; q and k are zero-padded to its d_qk, except on bf16
    where their strides suit TMA (rows of whole 16 bytes: the smoke 48 /
    32), whose tensor maps read them at D and fill the rest of the tile
    with zeros.  The scale stays 1/sqrt(D) of the unpadded D.  The zero
    columns add exact zeros to every score (bf16 and TF32 hi and lo of 0
    are 0) and fill only the discarded columns of out, so the result is
    the unpadded call's.  ``split`` is the f32
    kernel's split-pass scratch at the kernel's dims (``split_buffer(B,
    KV, Sk, dq, device, dv)`` with ``dq, dv = kernel_dims(D, DV)``;
    allocated here when None): after the call it holds what
    ``flash_split_plain`` computes of the (padded) k and v."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_fwd_cuda needs CUDA tensors")
    if not (q.dtype == k.dtype == v.dtype and q.dtype in _ENTRY):
        raise TypeError(f"flash_fwd_cuda takes f32 or bf16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    b, sq, h, d = q.shape
    _, sk, kvh, dk = k.shape
    dv = v.shape[-1]
    if (tuple(v.shape[:3]) != tuple(k.shape[:3]) or dk != d
            or k.shape[0] != b):
        raise ValueError(f"shape mismatch q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if h % kvh:
        raise ValueError(f"heads {h} do not group over {kvh} kv heads")
    bf16 = q.dtype == torch.bfloat16
    dq_k, dv_k = kernel_dims(d, dv)
    if dv_k != dv:
        v = torch.nn.functional.pad(v, (0, dv_k - dv))
    aligned = _tma_aligned if bf16 else _row_aligned
    q, k, v = (x if aligned(x) else x.contiguous() for x in (q, k, v))
    d_run = d if bf16_reads_unpadded(q, k) else dq_k
    if d_run != d:
        pad = (0, dq_k - d)
        q = torch.nn.functional.pad(q, pad)
        k = torch.nn.functional.pad(k, pad)
    out = torch.empty((b, sq, h, dv_k), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b == 0 or sq == 0:
        return out[..., :dv], lse
    if sk == 0:
        raise ValueError("flash_fwd_cuda needs at least one key")
    lib_name, name = _ENTRY[q.dtype]
    fn = getattr(build.library(lib_name), name)
    fn.restype = ctypes.c_int
    if bf16:
        fn.argtypes = BF16_ARGTYPES
        ptrs = (q, k, v, out, lse)
        strides = _tma_strides
    else:
        fn.argtypes = F32_ARGTYPES
        want = split_shape(b, kvh, sk, dq_k, dv_k)
        if split is None:
            split = torch.empty(want, dtype=torch.float32, device=q.device)
        elif (tuple(split.shape) != want or split.dtype != torch.float32
              or not split.is_contiguous() or split.device != q.device):
            raise ValueError(f"split scratch must be a contiguous f32 "
                             f"tensor of shape {want}")
        ptrs = (q, k, v, out, lse, split)
        strides = lambda x: x.stride()[:3]
    err = fn(*(x.data_ptr() for x in ptrs), b, h, kvh, sq, sk, d_run, dv_k,
             *strides(q), *strides(k), *strides(v),
             *out.stride()[:3], int(causal), int(window), float(softcap),
             1.0 / math.sqrt(d), q.device.index,
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, name)
    flash_fwd_cuda.launches += 1
    if bf16:
        flash_fwd_cuda.launches_bf16 += 1
        dims = flash_fwd_cuda.launches_bf16_dims
        dims[dq_k, dv_k] = dims.get((dq_k, dv_k), 0) + 1
    if dv_k != dv:
        out = out[..., :dv].contiguous()
    return out, lse


flash_fwd_cuda.launches = 0          # launches of either kernel
flash_fwd_cuda.launches_bf16 = 0     # of those, the bf16 tensor-core kernel's
flash_fwd_cuda.launches_bf16_dims = {}   # ... by its (d_qk, d_v) instantiation


def _resolve_impl(impl: Optional[str], x: torch.Tensor) -> str:
    if impl is None:
        return "cuda" if x.is_cuda else "plain"
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    if impl not in ("cuda", "plain"):
        raise ValueError(f"unknown attention impl {impl!r}")
    return impl


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, impl):
        kw = dict(causal=causal, window=window, softcap=softcap)
        if impl == "cuda":
            out, lse = flash_fwd_cuda(q, k, v, **kw)
        else:
            out, lse = flash_fwd_plain(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_plain(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, impl: Optional[str] = None):
    """Differentiable attention, [B,Sq,H,D] x [B,Sk,KV,D] (k) x
    [B,Sk,KV,DV] (v) -> [B,Sq,H,DV] in q's dtype.

    ``impl`` None picks the CUDA kernel for CUDA tensors and the plain
    version for CPU tensors; ``"plain"`` forces the plain version (on
    either device) — the comparison runs use it.  Mixed dtypes (a bf16 q
    beside an f32 memory's K/V) run in the widest of the three, as jnp's
    promotion runs them: the f32 kernel, its output cast to q's dtype, and
    each gradient back in its input's dtype."""
    impl = _resolve_impl(impl, q)
    args = (bool(causal), int(window), float(softcap), impl)
    if q.dtype == k.dtype == v.dtype:
        return _FlashAttention.apply(q, k, v, *args)
    wide = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    out = _FlashAttention.apply(q.to(wide), k.to(wide), v.to(wide), *args)
    return out.to(q.dtype)
