"""RG-LRU scan of the port: CUDA forward and reverse-scan backward kernels,
their plain versions, and one ``torch.autograd.Function`` over them.

Port of ``repro/kernels/rglru/{ops,ref}.py``: ``h_t = a_t * h_{t-1} + b_t``
over b, a ``[B, S, W]`` in f32 with an optional initial state h0 ``[B, W]``;
returns (h ``[B, S, W]``, h_final ``[B, W]``).

* ``rglru_fwd_cuda`` / ``rglru_bwd_cuda`` launch the Hopper kernels of
  ``csrc/rglru_scan.cu`` (the forward replaces the Pallas
  ``rglru_scan_pallas``; the TPU kernel has no backward, the JAX package
  differentiates its plain scan).
* ``rglru_scan_plain`` is ``ref.py``'s sequential scan, one multiply and one
  add per step, each rounded; ``rglru_scan_bwd_plain`` is the reverse
  recurrence ``g_t = dh_t + a_{t+1} g_{t+1}`` (``g_{S-1} = dh_{S-1} +
  dh_final``) with ``db = g``, ``da_t = g_t h_{t-1}`` and ``dh0 = a_0 g_0``.
  The kernels do the same operations in the same order, so on the card they
  are bitwise equal to these.
* ``rglru_scan`` is the dispatcher: the kernels for CUDA tensors, the plain
  versions for CPU tensors or when ``impl="plain"`` is asked for.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build


def _init(x: torch.Tensor, bw: Tuple[int, int],
          h0: Optional[torch.Tensor]) -> torch.Tensor:
    if h0 is None:
        return torch.zeros(bw, dtype=x.dtype, device=x.device)
    return h0.to(x.dtype)


def rglru_scan_plain(b: torch.Tensor, a: torch.Tensor,
                     h0: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: (h [B,S,W], h_final [B,W]), one step at a time, in
    b's dtype (f32 from the dispatcher)."""
    bsz, s, w = b.shape
    out = torch.empty((bsz, s, w), dtype=b.dtype, device=b.device)
    h = _init(b, (bsz, w), h0)
    for t in range(s):
        torch.mul(a[:, t], h, out=out[:, t])
        out[:, t] += b[:, t]
        h = out[:, t]
    return out, h.clone()


def rglru_scan_bwd_plain(a: torch.Tensor, h: torch.Tensor,
                         h0: Optional[torch.Tensor], dh: torch.Tensor,
                         dh_final: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    Optional[torch.Tensor]]:
    """Plain reverse-scan backward: (db, da, dh0); dh0 is None without h0."""
    bsz, s, w = a.shape
    g = torch.empty_like(a)
    carry = _init(a, (bsz, w), dh_final)
    for t in range(s - 1, -1, -1):
        torch.add(dh[:, t], carry, out=g[:, t])
        carry = a[:, t] * g[:, t]
    h_prev = torch.cat([_init(a, (bsz, w), h0)[:, None], h[:, :-1]],
                       dim=1)[:, :s]
    return g, g * h_prev, (carry if h0 is not None else None)


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _check(x: Optional[torch.Tensor], shape, what: str) -> None:
    if x is None:
        return
    if not (x.is_cuda and x.dtype == torch.float32 and x.is_contiguous()
            and tuple(x.shape) == tuple(shape)):
        raise ValueError(f"rglru kernel: {what} must be a contiguous f32 CUDA "
                         f"tensor of shape {tuple(shape)}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def rglru_fwd_cuda(b: torch.Tensor, a: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper forward kernel: (h [B,S,W], h_final [B,W])."""
    bsz, s, w = b.shape
    for x, what in ((b, "b"), (a, "a")):
        _check(x, (bsz, s, w), what)
    _check(h0, (bsz, w), "h0")
    h = torch.empty((bsz, s, w), dtype=torch.float32, device=b.device)
    hfin = torch.empty((bsz, w), dtype=torch.float32, device=b.device)
    if bsz * w == 0:
        return h, hfin
    fn = build.library("rglru_scan").rglru_fwd_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.c_void_p])
    err = fn(b.data_ptr(), a.data_ptr(), _ptr(h0), h.data_ptr(),
             hfin.data_ptr(), bsz, s, w, b.device.index, _stream(b))
    build.check(err, "rglru_fwd_f32")
    rglru_fwd_cuda.launches += 1
    return h, hfin


rglru_fwd_cuda.launches = 0


def rglru_bwd_cuda(a: torch.Tensor, h: torch.Tensor,
                   h0: Optional[torch.Tensor], dh: torch.Tensor,
                   dh_final: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Optional[torch.Tensor]]:
    """Launch the Hopper reverse-scan kernel: (db, da, dh0); dh0 is None
    without h0."""
    bsz, s, w = a.shape
    for x, what in ((a, "a"), (h, "h"), (dh, "dh")):
        _check(x, (bsz, s, w), what)
    _check(h0, (bsz, w), "h0")
    _check(dh_final, (bsz, w), "dh_final")
    db = torch.empty((bsz, s, w), dtype=torch.float32, device=a.device)
    da = torch.empty_like(db)
    dh0 = (torch.empty((bsz, w), dtype=torch.float32, device=a.device)
           if h0 is not None else None)
    if bsz * w == 0:
        return db, da, dh0
    fn = build.library("rglru_scan").rglru_bwd_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.c_void_p])
    err = fn(a.data_ptr(), h.data_ptr(), _ptr(h0), dh.data_ptr(),
             _ptr(dh_final), db.data_ptr(), da.data_ptr(), _ptr(dh0),
             bsz, s, w, a.device.index, _stream(a))
    build.check(err, "rglru_bwd_f32")
    rglru_bwd_cuda.launches += 1
    return db, da, dh0


rglru_bwd_cuda.launches = 0


def _resolve_impl(impl: Optional[str], x: torch.Tensor) -> str:
    if impl is None:
        return "cuda" if x.is_cuda else "plain"
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    if impl not in ("cuda", "plain"):
        raise ValueError(f"unknown rglru impl {impl!r}")
    return impl


class _RGLRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, b, a, h0, impl):
        ctx.set_materialize_grads(False)
        if impl == "cuda":
            h, hfin = rglru_fwd_cuda(b, a, h0)
        else:
            h, hfin = rglru_scan_plain(b, a, h0)
        ctx.save_for_backward(a, h, h0)
        ctx.impl = impl
        return h, hfin

    @staticmethod
    def backward(ctx, dh, dh_final):
        a, h, h0 = ctx.saved_tensors
        if dh is None:
            dh = torch.zeros_like(h)
        if ctx.impl == "cuda":
            db, da, dh0 = rglru_bwd_cuda(
                a, h, h0, dh.contiguous(),
                dh_final.contiguous() if dh_final is not None else None)
        else:
            db, da, dh0 = rglru_scan_bwd_plain(a, h, h0, dh, dh_final)
        need_b, need_a, need_h0, _ = ctx.needs_input_grad
        return (db if need_b else None, da if need_a else None,
                dh0 if need_h0 else None, None)


def rglru_scan(b: torch.Tensor, a: torch.Tensor,
               h0: Optional[torch.Tensor] = None, *,
               impl: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable ``h_t = a_t h_{t-1} + b_t``: (h [B,S,W], h_final [B,W]).

    b and a are cast to f32, as the JAX dispatcher does.  ``impl`` None
    picks the CUDA kernels for CUDA tensors and the plain versions for CPU
    tensors; ``"plain"`` forces the plain versions (on either device) — the
    comparison runs use it."""
    impl = _resolve_impl(impl, b)
    b32, a32 = b.float(), a.float()
    h0 = h0.float() if h0 is not None else None
    if impl == "cuda":
        b32, a32 = b32.contiguous(), a32.contiguous()
        h0 = h0.contiguous() if h0 is not None else None
    return _RGLRUScan.apply(b32, a32, h0, impl)
