"""Fused bucket update: CUDA kernel, its plain version, and the
whole-state optimizer step of the flat engine.

* ``bucket_update_ref``  — plain PyTorch version of one bucket's update
  (port of ``repro/kernels/bucket_update/ref.py::bucket_update_ref``):
  pure, returns new tensors.
* ``bucket_update_cuda`` — launches the Hopper kernel
  (csrc/bucket_update.cu, replacing the Pallas ``bucket_update_pallas``):
  updates p/m/v in place and, with ``zero_grads``, zeroes g in the same
  pass.  Bitwise equal to ``bucket_update_ref`` on the same inputs.
* ``bucket_update``      — the dispatcher: the kernel for CUDA tensors,
  the plain version (written back in place) for CPU tensors, or the
  plain version on either device when ``impl="plain"`` is asked for.
* ``apply_bucket_updates`` — one (delayed) optimizer update over every
  bucket: global-norm clip (plain torch ops, as JAX keeps it outside
  Pallas), then one update per bucket, step counter advanced once.
  With ``shard_id`` it runs on one rank's spans of the sharded flat
  engine (port of the JAX package's sharded mode): every gradient span's
  padded tail is zeroed first, the kernels run unmasked over whole spans
  and the clip norm is summed across ranks by ``norm_psum``.
  With ``master_dtype="bf16sr"`` the param buffers are bf16 residents:
  each bucket (or span) upcasts to f32 for the fused update and the
  result is rounded back into the same bf16 buffer by the seeded
  stochastic-rounding kernel (``kernels/quantize``), seed
  ``wire_seed(step, bucket)``, over the buffer's own indices.

Scalars ride one f32 (1, 128) device row [grad_scale, clip, lr, bc1,
bc2] (``pack_scalars``), so the clip factor computed on the device never
syncs to the host.
"""
from __future__ import annotations

import ctypes
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.bucket_update.segments import BucketSegments
from repro_torch.kernels.quantize import (
    HashIndex,
    stochastic_round_bf16,
    wire_seed,
)
from repro_torch.optim.optimizers import OptimizerSpec, clip_factor

SCALARS_GRAD_SCALE = 0
SCALARS_CLIP = 1
SCALARS_LR = 2
SCALARS_BC1 = 3
SCALARS_BC2 = 4
_N_SCALARS = 5
_LANES = 128


def pack_scalars(spec: OptimizerSpec, step_new: torch.Tensor, *, grad_scale,
                 clip, lr_scale=1.0) -> torch.Tensor:
    """Dynamic per-update scalars as one (1, 128) f32 row.  The bias
    corrections are computed in f32 from the int step, as JAX does."""
    dev = step_new.device
    vals = [grad_scale, clip, spec.lr * lr_scale]
    if spec.name == "adamw":
        sf = step_new.float()
        vals += [1 - spec.beta1 ** sf, 1 - spec.beta2 ** sf]
    else:
        vals += [0.0, 0.0]
    row = torch.stack([torch.as_tensor(x, dtype=torch.float32, device=dev)
                       for x in vals])
    pad = torch.zeros((_LANES - _N_SCALARS,), dtype=torch.float32, device=dev)
    return torch.cat([row, pad]).reshape(1, _LANES)


def _keep_tail(new: torch.Tensor, old: torch.Tensor, n_valid: int) -> torch.Tensor:
    if n_valid >= new.shape[0]:
        return new
    return torch.cat([new[:n_valid], old[n_valid:]])


def bucket_update_ref(spec: OptimizerSpec, p, m, v, g, scalars, *,
                      n_valid: int, uniform: Optional[Tuple[float, float]],
                      elem_hparams=None, zero_grads: bool = False):
    """Plain version: (p', m', v'|None, zeroed-g|None), tail kept."""
    gscale, clip, lr = scalars[0, 0], scalars[0, 1], scalars[0, 2]
    if uniform is not None:
        sc, wd = uniform
    else:
        sc, wd = elem_hparams
    ghat = (g * gscale) * clip
    if spec.name == "sgd":
        m_new = spec.momentum * m + ghat
        u = m_new
        if (uniform is None) or wd:
            u = u + wd * p
        p_new = p - (lr * sc) * u
        v_new = None
    elif spec.name == "adamw":
        bc1, bc2 = scalars[0, 3], scalars[0, 4]
        b1, b2 = spec.beta1, spec.beta2
        m_new = b1 * m + (1 - b1) * ghat
        v_new = b2 * v + (1 - b2) * ghat * ghat
        u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + spec.eps)
        if (uniform is None) or wd:
            u = u + wd * p
        p_new = p - (lr * sc) * u
        v_new = _keep_tail(v_new, v, n_valid)
    else:
        raise ValueError(spec.name)
    p_new = _keep_tail(p_new, p, n_valid)
    m_new = _keep_tail(m_new, m, n_valid)
    gz = torch.zeros_like(g) if zero_grads else None
    return p_new, m_new, v_new, gz


def _check_buffer(x: torch.Tensor, n: int, what: str) -> None:
    if not (x.is_cuda and x.dtype == torch.float32 and x.is_contiguous()
            and x.numel() == n and x.data_ptr() % 16 == 0):
        raise ValueError(f"bucket_update_cuda: {what} must be a contiguous, "
                         f"16-byte aligned f32 CUDA tensor of {n} elements")


def bucket_update_cuda(spec: OptimizerSpec, p, m, v, g, scalars, *,
                       n_valid: int, uniform: Optional[Tuple[float, float]],
                       elem_hparams=None, zero_grads: bool = False) -> None:
    """Launch the Hopper kernel on one bucket (in place)."""
    adam = spec.name == "adamw"
    if spec.name not in ("adamw", "sgd"):
        raise ValueError(spec.name)
    n = p.numel()
    if n % _LANES:
        raise ValueError(f"bucket buffer length {n} is not a multiple of "
                         f"{_LANES}; build the layout with pad_multiple=128")
    for x, what in ((p, "p"), (m, "m"), (g, "g")) + (((v, "v"),) if adam else ()):
        _check_buffer(x, n, what)
    if not (scalars.is_cuda and scalars.dtype == torch.float32
            and scalars.is_contiguous() and scalars.numel() >= _N_SCALARS):
        raise ValueError("bucket_update_cuda: scalars must be f32 on the card")
    sc_ptr = wd_ptr = None
    if uniform is None:
        sc_arr, wd_arr = elem_hparams
        _check_buffer(sc_arr, n, "sc")
        _check_buffer(wd_arr, n, "wd")
        sc_ptr, wd_ptr = sc_arr.data_ptr(), wd_arr.data_ptr()
        sc_u, wd_u, has_wd = 0.0, 0.0, 1
    else:
        sc_u, wd_u = uniform
        has_wd = int(bool(wd_u))
    if n == 0:
        return
    lib = build.library("bucket_update")
    fn = lib.bucket_update_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_float] * 6
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    sms = torch.cuda.get_device_properties(p.device).multi_processor_count
    err = fn(p.data_ptr(), m.data_ptr(), v.data_ptr() if adam else None,
             g.data_ptr(), sc_ptr, wd_ptr, scalars.data_ptr(), n, int(n_valid),
             float(sc_u), float(wd_u), has_wd, int(adam),
             spec.beta1, 1 - spec.beta1, spec.beta2, 1 - spec.beta2,
             spec.eps, spec.momentum, int(zero_grads), 16 * sms,
             p.device.index, torch.cuda.current_stream(p.device).cuda_stream)
    build.check(err, "bucket_update_f32")
    bucket_update_cuda.launches += 1


bucket_update_cuda.launches = 0


def bucket_update(spec: OptimizerSpec, p, m, v, g, scalars, *, n_valid: int,
                  uniform: Optional[Tuple[float, float]], elem_hparams=None,
                  zero_grads: bool = False, impl: Optional[str] = None) -> None:
    """One fused optimizer step over one flat bucket, in place."""
    if impl is None:
        impl = "cuda" if p.is_cuda else "plain"
    if impl == "cuda":
        bucket_update_cuda(spec, p, m, v, g, scalars, n_valid=n_valid,
                           uniform=uniform, elem_hparams=elem_hparams,
                           zero_grads=zero_grads)
        return
    if impl != "plain":
        raise ValueError(f"unknown bucket-update impl {impl!r}")
    p2, m2, v2, _ = bucket_update_ref(
        spec, p, m, v, g, scalars, n_valid=n_valid, uniform=uniform,
        elem_hparams=elem_hparams)
    p.copy_(p2)
    m.copy_(m2)
    if v2 is not None:
        v.copy_(v2)
    if zero_grads:
        g.zero_()


def init_flat_opt_state(spec: OptimizerSpec, buf_sizes: Sequence[int],
                        device="cuda") -> Dict[str, Any]:
    """Per-bucket f32 moment buffers and an int32 step counter."""
    zeros = lambda: tuple(torch.zeros((s,), dtype=torch.float32, device=device)
                          for s in buf_sizes)
    out: Dict[str, Any] = {
        "step": torch.zeros((), dtype=torch.int32, device=device), "m": zeros()}
    if spec.name == "adamw":
        out["v"] = zeros()
    elif spec.name != "sgd":
        raise ValueError(spec.name)
    return out


def apply_bucket_updates(spec: OptimizerSpec, segments: BucketSegments,
                         pbuf: Sequence[torch.Tensor],
                         gbuf: Sequence[torch.Tensor], opt: Dict[str, Any], *,
                         grad_scale=1.0, lr_scale=1.0, zero_grads: bool = False,
                         impl: Optional[str] = None,
                         shard_id: Optional[int] = None,
                         norm_psum: Optional[Callable] = None,
                         master_dtype: Optional[str] = None,
                         quantize_impl: Optional[str] = None,
                         model_norm: Optional[Callable] = None,
                         sr_index: Optional[Sequence[HashIndex]] = None
                         ) -> Tuple[Tuple[torch.Tensor, ...], Dict[str, Any],
                                    Optional[Tuple[torch.Tensor, ...]]]:
    """One (delayed) optimizer update across all bucket buffers, in place.

    Mirrors ``apply_updates`` on the flat representation: scale by
    ``grad_scale``, clip by the global norm over every bucket's valid
    span, then one fused update per bucket.  A bf16sr master (bf16
    ``pbuf``) is updated through a transient f32 copy of one bucket at a
    time and rounded back into its buffer; the moments stay f32.
    ``quantize_impl`` picks the rounding's implementation.

    **Sharded mode** (``shard_id`` given): every buffer is this rank's
    span of its bucket (``layout.shard_sizes[b]`` elements from global
    offset ``shard_id * span``).  The padded tail lies in the trailing
    spans, so which elements are valid depends on the shard: each
    gradient span's tail is zeroed in place (hostile values there cannot
    reach the norm or the params), and the kernels run unmasked over the
    whole span (``n_valid = span``; the p/m/v tails are zero by the
    engine's invariant, and a zero gradient keeps them zero).  The squared
    norm of the spans is summed across ranks by ``norm_psum``, which grad
    clipping therefore requires.

    **Over a 'model' axis** (``model_norm`` given): the buffers hold this
    rank's shards of the leaves split over 'model' beside whole replicated
    leaves, and the clip norm is ``model_norm`` of the buffers or spans
    (``sharding.tp.SpanNorm``: the split stretches' squares summed across
    the model ranks, after ``norm_psum``'s sum over the spans where
    sharded).  ``sr_index`` (per bucket a ``kernels.quantize.HashIndex``)
    gives the positions the bf16sr rounding's hash reads: there, each
    element's place in JAX's global bucket (or its span), so that a whole
    leaf rounds alike on every model rank and a split leaf as JAX's does.

    Returns (pbuf, opt, zeroed gbuf | None) — the same tensors, updated."""
    layout = segments.layout
    adam = spec.name == "adamw"
    if master_dtype not in (None, "f32", "bf16sr"):
        raise ValueError(f"master_dtype={master_dtype!r}")
    bf16sr = master_dtype == "bf16sr"
    sharded = shard_id is not None
    if sharded and spec.grad_clip and norm_psum is None:
        raise ValueError(
            "sharded update with grad_clip needs norm_psum: each rank sees "
            "1/N of the gradient, so a local norm would clip every shard "
            "differently")
    dev = pbuf[0].device
    if sharded:
        spans = layout.shard_sizes
        for b, g in enumerate(gbuf):
            valid = min(max(layout.sizes[b] - shard_id * spans[b], 0), spans[b])
            if valid < spans[b]:
                g[valid:].zero_()
    if spec.grad_clip and model_norm is not None:
        clip = clip_factor(spec, model_norm(
            gbuf, grad_scale=grad_scale, shard_id=shard_id, psum=norm_psum))
    elif spec.grad_clip:
        if sharded:
            sq = [torch.sum(torch.square(g * grad_scale)) for g in gbuf]
            gn = torch.sqrt(norm_psum(torch.sum(torch.stack(sq))))
        else:
            sq = [torch.sum(torch.square(g[: layout.sizes[b]] * grad_scale))
                  for b, g in enumerate(gbuf)]
            gn = torch.sqrt(torch.sum(torch.stack(sq)))
        clip = clip_factor(spec, gn)
    else:
        clip = torch.ones((), dtype=torch.float32, device=dev)
    step_new = opt["step"] + 1
    scalars = pack_scalars(spec, step_new, grad_scale=grad_scale, clip=clip,
                           lr_scale=lr_scale)
    for b in range(layout.n_buckets):
        uniform = segments.uniform(b)
        elem = None if uniform is not None else segments.device_hparams(
            b, dev, shard=shard_id)
        p = pbuf[b].float() if bf16sr else pbuf[b]
        bucket_update(spec, p, opt["m"][b],
                      opt["v"][b] if adam else None, gbuf[b], scalars,
                      n_valid=spans[b] if sharded else layout.sizes[b],
                      uniform=uniform, elem_hparams=elem,
                      zero_grads=zero_grads, impl=impl)
        if not bf16sr:
            continue
        stochastic_round_bf16(p, wire_seed(step_new, b), impl=quantize_impl,
                              out=pbuf[b],
                              index=None if sr_index is None else sr_index[b])
        del p   # free this bucket's f32 copy before the next one's
    opt["step"] = step_new
    return tuple(pbuf), opt, (tuple(gbuf) if zero_grads else None)
