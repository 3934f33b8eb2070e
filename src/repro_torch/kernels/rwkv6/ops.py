"""RWKV-6 WKV of the port: chunked CUDA forward and backward kernels, their
plain versions, and one ``torch.autograd.Function`` over them.

Port of ``repro/kernels/rwkv6/{ref,ops}.py``.  Per head, with the state S
``[D_k, D_v]``, ``o_t = r_t (S + diag(u) k_tᵀ v_t)`` and
``S = diag(w_t) S + k_tᵀ v_t``.  Layout as the JAX package's: r, k, v, w
``[B, S, H, D]``, u ``[H, D]``, s0 ``[B, H, D, D]``; every function returns
o ``[B, S, H, D]`` and S_final ``[B, H, D, D]``, in f32 from the dispatcher
(the plain versions keep their inputs' dtype, so float64 gradchecks run).

* ``rwkv6_reference_plain`` is ``ref.py``: one token at a time.
* ``rwkv6_chunked_plain`` is ``ops.py::_chunked_jnp``: chunks of T = 32
  (a ragged end padded with r = k = v = 0, w = 1), within a chunk
  ``logw = log(max(w, 1e-30))``, its inclusive and exclusive cumulative
  sums, ``rd = r e^{lw_exc}``, ``kd = k e^{-lw_inc}``, ``A`` the strictly
  lower ``rd kdᵀ`` plus the diagonal ``Σ r∘u∘k``, ``o = A v + rd S`` and
  ``S' = e^{lw_end}∘S + (k e^{lw_end - lw})ᵀ v``.  What does not depend on
  the state is computed for all chunks at once; only the state update runs
  in the loop over chunks.
* ``rwkv6_bwd_plain`` is the chunked reverse pass (the TPU kernel has no
  VJP; the JAX package differentiates ``_chunked_jnp``): every chunk's
  ``rdᵀ do`` at once, then the state cotangent dS carried from the last
  chunk to the first, ``dS_in = rdᵀ do + e^{lw_end}∘dS_out``, and every
  chunk's gradients from its own inputs, its chunk-start state and its
  dS_out.
* ``rwkv6_fwd_cuda`` / ``rwkv6_bwd_cuda`` launch the Hopper kernels of
  ``csrc/rwkv6.cu``, which do the same operations in the same order (the
  forward replaces the Pallas ``rwkv6_pallas``).  Each direction is one C
  call: chunk-parallel state contributions, an elementwise scan over the
  chunks (forward from the first, backward from the last), then the
  chunk-parallel outputs or gradients (and, backward, du's sum).
* ``rwkv6_mix`` is the dispatcher: the kernels for CUDA tensors; on CPU
  tensors the token loop up to S = 128 and the chunked pair beyond, as the
  JAX dispatcher picks off the TPU; ``impl="plain"`` (or ``"chunked"``)
  forces the chunked plain pair on either device.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

CHUNK = 32
REF_MAX_SEQ = 128     # the token loop below this, as the JAX dispatcher
KERNEL_HEAD_DIMS = (32, 64)


def _init(r: torch.Tensor, s0: Optional[torch.Tensor]) -> torch.Tensor:
    if s0 is not None:
        return s0.to(r.dtype)
    b, _, h, d = r.shape
    return torch.zeros((b, h, d, d), dtype=r.dtype, device=r.device)


def rwkv6_reference_plain(r, k, v, w, u, s0=None):
    """``ref.py``: one token at a time, in r's dtype (f32 from the
    dispatcher); differentiable by autograd."""
    state = _init(r, s0)
    uf = u.to(r.dtype)[None, :, :, None]
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]        # [B,H,Dk,Dv]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], state + uf * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(outs, dim=1), state


# ---------------------------------------------------------------------------
# chunked plain pair
# ---------------------------------------------------------------------------
def _to_chunks(t: torch.Tensor, pad: int, value: float) -> torch.Tensor:
    """[B, S, H, D] -> [B, H, NC, T, D], the ragged end padded."""
    b, s, h, d = t.shape
    if pad:
        t = torch.cat([t, t.new_full((b, pad, h, d), value)], dim=1)
    return t.reshape(b, -1, CHUNK, h, d).permute(0, 3, 1, 2, 4)


def _from_chunks(t: torch.Tensor, s: int) -> torch.Tensor:
    """[B, H, NC, T, D] -> [B, S, H, D] (the padding dropped)."""
    b, h, nc, c, d = t.shape
    return t.permute(0, 2, 3, 1, 4).reshape(b, nc * c, h, d)[:, :s]


class _Chunks:
    """The state-independent quantities of every chunk at once."""

    def __init__(self, r, k, v, w, u):
        s = r.shape[1]
        pad = (-s) % CHUNK
        self.r, self.k, self.v = (_to_chunks(t, pad, 0.0) for t in (r, k, v))
        self.w = _to_chunks(w, pad, 1.0)
        self.u = u.to(r.dtype)[None, :, None, None, :]         # [1,H,1,1,D]
        logw = torch.log(torch.clamp_min(self.w, 1e-30))
        lw_inc = torch.cumsum(logw, dim=3)
        lw_exc = lw_inc - logw
        lw_end = lw_inc[:, :, :, -1:, :]
        self.e_exc = torch.exp(lw_exc)
        self.e_inc = torch.exp(-lw_inc)
        self.e_end = torch.exp(lw_end - lw_inc)
        self.ew = torch.exp(lw_end[:, :, :, 0, :])             # [B,H,NC,D]
        self.rd = self.r * self.e_exc
        self.kd = self.k * self.e_inc
        self.ke = self.k * self.e_end
        tri = torch.ones(CHUNK, CHUNK, dtype=torch.bool, device=r.device)
        self.strict = torch.tril(tri, diagonal=-1)
        self.eye = torch.eye(CHUNK, dtype=torch.bool, device=r.device)
        diag = torch.sum(self.r * (self.u * self.k), dim=-1)   # [B,H,NC,T]
        a = torch.where(self.strict, self.rd @ self.kd.transpose(-1, -2), 0.0)
        self.a = a + torch.where(self.eye, diag[..., None], 0.0)


def _chunked_forward(r, k, v, w, u, s0=None):
    """(o, S_final, states [B,H,NC,D,D]): the chunk-start states are what
    the backward reads."""
    c = _Chunks(r, k, v, w, u)
    state = _init(r, s0)
    kv = c.ke.transpose(-1, -2) @ c.v                          # [B,H,NC,D,D]
    states = torch.empty_like(kv)
    for i in range(kv.shape[2]):
        states[:, :, i] = state
        state = c.ew[:, :, i, :, None] * state + kv[:, :, i]
    o = c.a @ c.v + c.rd @ states
    return _from_chunks(o, r.shape[1]), state, states


def rwkv6_chunked_plain(r, k, v, w, u, s0=None):
    """``_chunked_jnp``: (o [B,S,H,D], S_final [B,H,D,D]) in r's dtype."""
    o, sfin, _ = _chunked_forward(r, k, v, w, u, s0)
    return o, sfin


def rwkv6_bwd_plain(r, k, v, w, u, s0, do, ds_final=None, states=None):
    """Chunked reverse pass: (dr, dk, dv, dw, du, ds0), ds0 None without s0.

    ``states`` are the forward's chunk-start states (recomputed when not
    given).  Every chunk's ``rdᵀ do`` at once, then dS runs from the last
    chunk to the first; then, for every chunk at once:
    ``dv = Aᵀ do + k_end dS_out``; ``dA = tril_strict(do vᵀ)`` and the
    diagonal's ``do_t·v_t`` (through ``r∘u∘k`` into dr, dk and du);
    ``drd = dA kd + do S_inᵀ``, ``dkd = dAᵀ rd``, ``dk_end = v dS_outᵀ``;
    the log-decay gradients flow back through the cumulative sums to
    ``logw`` and to ``w`` as ``1/w`` where ``w > 1e-30``."""
    s = r.shape[1]
    if states is None:
        states = _chunked_forward(r, k, v, w, u, s0)[2]
    c = _Chunks(r, k, v, w, u)
    dout = _to_chunks(do, (-s) % CHUNK, 0.0)
    nc = dout.shape[2]
    ds = _init(r, ds_final)
    contrib = c.rd.transpose(-1, -2) @ dout                    # [B,H,NC,D,D]
    dstates = torch.empty_like(states)
    for i in range(nc - 1, -1, -1):
        dstates[:, :, i] = ds
        ds = contrib[:, :, i] + c.ew[:, :, i, :, None] * ds
    dv = c.a.transpose(-1, -2) @ dout + c.ke @ dstates
    da_full = dout @ c.v.transpose(-1, -2)
    ddiag = torch.diagonal(da_full, dim1=-2, dim2=-1)          # [B,H,NC,T]
    da = torch.where(c.strict, da_full, 0.0)
    drd = da @ c.kd + dout @ states.transpose(-1, -2)
    dkd = da.transpose(-1, -2) @ c.rd
    dke = c.v @ dstates.transpose(-1, -2)
    gu = ddiag[..., None] * c.u                                # d(r∘u∘k)/d·
    dr = drd * c.e_exc + gu * c.k
    dk = dkd * c.e_inc + dke * c.e_end + gu * c.r
    du = torch.sum(ddiag[..., None] * c.r * c.k, dim=(0, 2, 3))
    dlw_exc = drd * c.rd
    pke = dke * c.ke
    g = dlw_exc - dkd * c.kd - pke
    dlw_end = (torch.sum(pke, dim=3)
               + c.ew * torch.sum(states * dstates, dim=-1))   # [B,H,NC,D]
    rcum = torch.flip(torch.cumsum(torch.flip(g, (3,)), dim=3), (3,))
    dlogw = rcum + dlw_end[:, :, :, None, :] - dlw_exc
    dw = torch.where(c.w > 1e-30, dlogw / c.w, 0.0)
    grads = [_from_chunks(t, s) for t in (dr, dk, dv, dw)]
    return (*grads, du, ds if s0 is not None else None)


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------
def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _check(x: Optional[torch.Tensor], shape, what: str) -> None:
    if x is None:
        return
    if not (x.is_cuda and x.dtype == torch.float32 and x.is_contiguous()
            and tuple(x.shape) == tuple(shape) and x.data_ptr() % 16 == 0):
        raise ValueError(f"rwkv6 kernel: {what} must be a contiguous, 16-byte "
                         f"aligned f32 CUDA tensor of shape {tuple(shape)}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def _check_inputs(r, k, v, w, u, s0):
    b, s, h, d = r.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"rwkv6 kernel: head size {d} not in "
                         f"{KERNEL_HEAD_DIMS}")
    for x, what in ((r, "r"), (k, "k"), (v, "v"), (w, "w")):
        _check(x, (b, s, h, d), what)
    _check(u, (h, d), "u")
    _check(s0, (b, h, d, d), "s0")
    return b, s, h, d


# the C entry points' parameters: device pointers, then B, S, H, D, the
# device index and the stream
FWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 4
                + [ctypes.c_int, ctypes.c_void_p])
BWD_ARGTYPES = ([ctypes.c_void_p] * 17 + [ctypes.c_longlong] * 4
                + [ctypes.c_int, ctypes.c_void_p])


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _n_chunks(s: int) -> int:
    return (s + CHUNK - 1) // CHUNK


def rwkv6_fwd_cuda(r, k, v, w, u, s0=None, *, save_states: bool = False):
    """Launch the Hopper forward kernels (state contributions, state scan,
    outputs: one C call, one count): (o, S_final, states).  ``states``
    [B, H, NC, D, D] (the chunk-start states) is returned only with
    ``save_states``; without it the buffer is still allocated, as the
    scan's scratch, and dropped on return."""
    b, s, h, d = _check_inputs(r, k, v, w, u, s0)
    nc = _n_chunks(s)
    dev = r.device
    o = torch.empty((b, s, h, d), dtype=torch.float32, device=dev)
    sfin = torch.empty((b, h, d, d), dtype=torch.float32, device=dev)
    states = torch.empty((b, h, nc, d, d), dtype=torch.float32, device=dev)
    if b * h == 0:
        return o, sfin, states if save_states else None
    ew = torch.empty((b, h, nc, d), dtype=torch.float32, device=dev)
    fn = build.library("rwkv6").rwkv6_fwd_f32
    fn.restype = ctypes.c_int
    fn.argtypes = FWD_ARGTYPES
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), _ptr(s0), o.data_ptr(), sfin.data_ptr(),
             states.data_ptr(), ew.data_ptr(), b, s, h, d, dev.index,
             _stream(r))
    build.check(err, "rwkv6_fwd_f32")
    rwkv6_fwd_cuda.launches += 1
    return o, sfin, states if save_states else None


rwkv6_fwd_cuda.launches = 0


def rwkv6_bwd_cuda(r, k, v, w, u, states, do, ds_final=None, *,
                   need_ds0: bool = False):
    """Launch the Hopper backward kernels (chunk contributions, reverse
    scan, gradients, du's sum: one C call, one count): (dr, dk, dv, dw, du,
    ds0); ds0 only with ``need_ds0``.  ``states`` are the forward's
    chunk-start states (``rwkv6_fwd_cuda(..., save_states=True)``)."""
    b, s, h, d = _check_inputs(r, k, v, w, u, None)
    nc = _n_chunks(s)
    _check(states, (b, h, nc, d, d), "states")
    _check(do, (b, s, h, d), "do")
    _check(ds_final, (b, h, d, d), "ds_final")
    dev = r.device
    grads = [torch.empty((b, s, h, d), dtype=torch.float32, device=dev)
             for _ in range(4)]
    du = torch.empty((h, d), dtype=torch.float32, device=dev)
    ds0 = (torch.empty((b, h, d, d), dtype=torch.float32, device=dev)
           if need_ds0 else None)
    if b * h == 0:
        return (*grads, du.zero_(), ds0)
    # scratch: every chunk's rdᵀ do, then its state cotangent dS_out;
    # e^{lw_end} of every chunk; du's partial sums
    dstates = torch.empty_like(states)
    ew = torch.empty((b, h, nc, d), dtype=torch.float32, device=dev)
    du_part = torch.empty((b, h, nc, d), dtype=torch.float32, device=dev)
    fn = build.library("rwkv6").rwkv6_bwd_f32
    fn.restype = ctypes.c_int
    fn.argtypes = BWD_ARGTYPES
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), states.data_ptr(), do.data_ptr(), _ptr(ds_final),
             *(g.data_ptr() for g in grads), du.data_ptr(), _ptr(ds0),
             dstates.data_ptr(), ew.data_ptr(), du_part.data_ptr(), b, s,
             h, d, dev.index, _stream(r))
    build.check(err, "rwkv6_bwd_f32")
    rwkv6_bwd_cuda.launches += 1
    return (*grads, du, ds0)


rwkv6_bwd_cuda.launches = 0


# ---------------------------------------------------------------------------
# autograd and dispatch
# ---------------------------------------------------------------------------
class _RWKV6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, impl):
        ctx.set_materialize_grads(False)
        if impl == "cuda":
            o, sfin, states = rwkv6_fwd_cuda(
                r, k, v, w, u, s0, save_states=any(ctx.needs_input_grad[:6]))
        else:
            o, sfin, states = _chunked_forward(r, k, v, w, u, s0)
        ctx.save_for_backward(r, k, v, w, u, s0, states)
        ctx.impl = impl
        return o, sfin

    @staticmethod
    def backward(ctx, do, ds_final):
        r, k, v, w, u, s0, states = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(r)
        if ctx.impl == "cuda":
            grads = rwkv6_bwd_cuda(
                r, k, v, w, u, states, do.contiguous(),
                ds_final.contiguous() if ds_final is not None else None,
                need_ds0=s0 is not None)
        else:
            grads = rwkv6_bwd_plain(r, k, v, w, u, s0, do, ds_final,
                                    states=states)
        return tuple(g if need else None for g, need
                     in zip(grads, ctx.needs_input_grad)) + (None,)


def _resolve_impl(impl: Optional[str], x: torch.Tensor) -> str:
    if impl is None:
        if x.is_cuda:
            return "cuda"
        return "ref" if x.shape[1] <= REF_MAX_SEQ else "chunked"
    if impl == "plain":
        return "chunked"
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    if impl not in ("cuda", "ref", "chunked"):
        raise ValueError(f"unknown rwkv6 impl {impl!r}")
    return impl


def rwkv6_mix(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              s0: Optional[torch.Tensor] = None, *,
              impl: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable RWKV-6 WKV: (o [B,S,H,D], S_final [B,H,D,D]).

    The inputs are cast to f32, as the JAX package computes.
    ``impl`` None picks the CUDA kernels for CUDA tensors, and for CPU
    tensors the token loop (``"ref"``) up to S = 128 and the chunked plain
    pair (``"chunked"``) beyond; ``"plain"`` is ``"chunked"`` on either
    device (the comparison runs use it)."""
    impl = _resolve_impl(impl, r)
    r, k, v, w, u = (t.float() for t in (r, k, v, w, u))
    s0 = s0.float() if s0 is not None else None
    if impl == "ref":
        return rwkv6_reference_plain(r, k, v, w, u, s0)
    if impl == "cuda":
        r, k, v, w, u = (t.contiguous() for t in (r, k, v, w, u))
        s0 = s0.contiguous() if s0 is not None else None
    return _RWKV6.apply(r, k, v, w, u, s0, impl)
