"""Wire-precision casts of the flat buckets: CUDA kernels, their plain
versions, and the one cast site of the precision policies.

Port of ``repro/kernels/quantize/{ops,ref}.py``:

* ``stochastic_round_bf16`` / ``quantize_int8`` / ``dequantize_int8`` —
  dispatchers: the Hopper kernels of ``csrc/quantize.cu`` (replacing the
  Pallas ``stochastic_round_bf16_pallas``, ``quantize_int8_pallas`` and
  ``dequantize_int8_pallas``) for CUDA tensors, the plain versions
  (``*_plain``) for CPU tensors or when ``impl="plain"`` is asked for.
  Each plain version repeats ``ref.py``'s expressions in the same order,
  so it is bitwise equal to the JAX package's ref and Pallas kernels on
  the CPU and to the CUDA kernels on the card.
* ``quantize_dequantize_int8`` — the int8 gradient-wire edge: the local
  contribution projected onto the blockwise int8 grid, written back into
  the same buffer (the q / scale scratch is transient).
* ``int8_scales`` — the grid's scales of given row maxima, for a caller
  that agrees the maxima of shared rows across ranks and then supplies
  the scales to ``quantize_int8`` (``scale=``).
* ``HashIndex`` — the positions the stochastic-rounding hash reads for a
  buffer whose elements sit elsewhere in the bucket JAX hashes (a model
  rank's shards, ``sharding.tp.hash_segments``).
* ``cast_compute`` — the single compute/wire dtype cast (a bare ``.to``).
* ``wire_seed`` — the per-(step, bucket) stochastic-rounding seed.

uint32 arithmetic on the CPU: PyTorch has no uint32 ``+``, ``*`` or
``>>``, so the plain hash carries uint32 values in int64 and masks to 32
bits after every step (an int64 product wraps modulo 2**64, which keeps
its low 32 bits right).  Seeds are uint32 values held in an int64 tensor
(or a Python int); the kernels read theirs from device memory, so a seed
derived from the on-device step counter never synchronises to the host.

Tails: every entry takes ``n_valid`` and writes zeros at and past it.
A NaN quotient in the int8 grid converts to 0, as XLA's convert does.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

LANES = 128
_M32 = 0xFFFFFFFF
# murmur3 fmix32 constants + golden-ratio seed spread (ref.py)
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
_SEED_MUL = 2654435761


def _rows(x: torch.Tensor) -> int:
    padded = x.numel()
    if x.dim() != 1 or padded % LANES:
        raise ValueError(f"flat buffer of shape {tuple(x.shape)} is not a "
                         f"{LANES}-lane multiple")
    return padded // LANES


def _n_valid(x: torch.Tensor, n_valid: Optional[int]) -> int:
    return x.numel() if n_valid is None else int(n_valid)


def _u32_seed(seed, device) -> torch.Tensor:
    """A uint32 seed as an int64 0-d tensor on ``device``."""
    if isinstance(seed, torch.Tensor):
        return seed.to(device=device, dtype=torch.int64) & _M32
    return torch.tensor(int(seed) & _M32, dtype=torch.int64, device=device)


def _resolve(impl: Optional[str], x: torch.Tensor) -> str:
    if impl is None:
        return "cuda" if x.is_cuda else "plain"
    if impl == "cuda" and not x.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    if impl not in ("cuda", "plain"):
        raise ValueError(f"unknown quantize impl {impl!r}")
    return impl


# ---------------------------------------------------------------------------
# plain versions (ports of ref.py, same expressions in the same order)
# ---------------------------------------------------------------------------
def hash_u32(idx: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer over ``idx + seed * GOLDEN`` in uint32 (int64
    tensors holding uint32 values)."""
    x = (idx + seed * _GOLDEN) & _M32
    x ^= x >> 16
    x *= _M1
    x &= _M32
    x ^= x >> 13
    x *= _M2
    x &= _M32
    x ^= x >> 16
    return x


@dataclasses.dataclass(frozen=True)
class HashIndex:
    """The positions the stochastic-rounding hash reads for the elements of
    a flat buffer, where they are not the buffer's own: element ``g`` sits
    at ``e = base + g`` of a bucket laid out in ``segments``, an int64
    ``[n, 4]`` table of ``(start, inner, position, stride)`` rows sorted by
    ``start`` (the first at 0).  In the row with the last ``start <= e``,
    with ``j = e - start``, the hash reads ``position + (j // inner) *
    stride + j % inner``, reduced modulo ``modulus`` when it is not 0.

    A model rank's bucket holds its shards of the split leaves: each leaf
    is a row, its shard ``inner``-element runs ``stride`` apart in the
    global bucket, so every element hashes at its place in JAX's global
    bucket (``sharding.tp.hash_segments``); a sharded engine's span gives
    its first element's place as ``base`` and JAX's span length as
    ``modulus``.  Each ``j`` and ``inner`` is below 2**31."""

    segments: torch.Tensor
    base: int = 0
    modulus: int = 0

    def positions(self, n: int, device) -> torch.Tensor:
        """The hash's position of each of ``n`` elements (int64)."""
        seg = self.segments.to(device)
        e = torch.arange(n, dtype=torch.int64, device=device) + self.base
        s = torch.searchsorted(seg[:, 0].contiguous(), e, right=True) - 1
        j = e - seg[s, 0]
        pos = seg[s, 2] + torch.div(j, seg[s, 1], rounding_mode="floor") \
            * seg[s, 3] + torch.remainder(j, seg[s, 1])
        return pos % self.modulus if self.modulus else pos


def stochastic_round_bf16_plain(x: torch.Tensor, seed,
                                n_valid: Optional[int] = None,
                                index: Optional[HashIndex] = None
                                ) -> torch.Tensor:
    """f32[padded] -> bf16[padded], seeded stochastic rounding, zero tail;
    the hash reads each element's ``index`` position where given."""
    _rows(x)
    n_valid = _n_valid(x, n_valid)
    idx = torch.arange(x.numel(), dtype=torch.int64, device=x.device)
    at = idx if index is None else index.positions(x.numel(), x.device)
    r = hash_u32(at & _M32, _u32_seed(seed, x.device)) & 0xFFFF
    del at
    bits = x.float().view(torch.int32).to(torch.int64) & _M32
    rounded = (bits + r) & 0xFFFF0000
    del r
    # the low half is zero: the top half is the exact bf16 value
    top = torch.where(idx < n_valid, rounded >> 16, 0)
    top = torch.where(top >= 0x8000, top - 0x10000, top)
    return top.to(torch.int16).view(torch.bfloat16)


def int8_scales(absmax: torch.Tensor) -> torch.Tensor:
    """The int8 grid's per-row scales of f32 row maxima ``absmax``:
    ``absmax / 127``, or 1 where ``absmax > 0`` is false (an all-zero
    row, or a NaN in the row), as the quantize kernels derive them."""
    inv = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=absmax.device)
    return torch.where(absmax > 0.0, absmax * inv, 1.0)


def quantize_int8_plain(x: torch.Tensor, n_valid: Optional[int] = None,
                        scale: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32[padded] -> (int8[padded], f32[rows] per-row scales); with
    ``scale`` (f32[rows]) the rows are quantized on those scales instead
    of their own, which come back as given."""
    rows = _rows(x)
    n_valid = _n_valid(x, n_valid)
    idx = torch.arange(x.numel(), device=x.device).reshape(rows, LANES)
    x2 = torch.where(idx < n_valid, x.float().reshape(rows, LANES), 0.0)
    del idx
    if scale is None:
        s = int8_scales(torch.amax(torch.abs(x2), dim=1, keepdim=True))
        scale = s[:, 0]
    else:
        _check_scale(scale, rows)
        s = scale[:, None]
    q = torch.clamp(torch.round(x2 / s), -127.0, 127.0)
    q = torch.nan_to_num(q, nan=0.0).to(torch.int8)
    return q.reshape(x.shape), scale


def _check_scale(scale: torch.Tensor, rows: int) -> None:
    if scale.dtype != torch.float32 or tuple(scale.shape) != (rows,):
        raise ValueError(f"a supplied int8 scale must be f32[{rows}], not "
                         f"{scale.dtype}{list(scale.shape)}")


def dequantize_int8_plain(q: torch.Tensor, scale: torch.Tensor,
                          n_valid: Optional[int] = None) -> torch.Tensor:
    """(int8[padded], f32[rows]) -> f32[padded], zero tail."""
    rows = _rows(q)
    n_valid = _n_valid(q, n_valid)
    idx = torch.arange(q.numel(), device=q.device).reshape(rows, LANES)
    y = q.reshape(rows, LANES).float() * scale[:, None]
    y = torch.where(idx < n_valid, y, 0.0)
    return y.reshape(q.shape)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------
def _check(x: torch.Tensor, dtype: torch.dtype, n: int, what: str) -> None:
    if not (x.is_cuda and x.dtype == dtype and x.is_contiguous()
            and x.numel() == n and x.data_ptr() % 16 == 0):
        raise ValueError(f"{what} must be a contiguous, 16-byte aligned "
                         f"{dtype} CUDA tensor of {n} elements")


def _launch(name: str, argtypes, *args) -> None:
    fn = getattr(build.library("quantize"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    build.check(fn(*args), name)


def _grid_cap(x: torch.Tensor) -> int:
    return 16 * torch.cuda.get_device_properties(x.device).multi_processor_count


_ARGS_TAIL = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
              ctypes.c_int, ctypes.c_void_p]


def stochastic_round_bf16_cuda(x: torch.Tensor, seed,
                               n_valid: Optional[int] = None, *,
                               out: Optional[torch.Tensor] = None,
                               index: Optional[HashIndex] = None
                               ) -> torch.Tensor:
    """Launch the Hopper stochastic-rounding kernel; writes ``out`` (a new
    bf16 buffer when None); the hash reads each element's ``index``
    position where given (its table on the card)."""
    n = x.numel()
    _rows(x)
    _check(x, torch.float32, n, "stochastic_round_bf16_cuda: x")
    if out is None:
        out = torch.empty((n,), dtype=torch.bfloat16, device=x.device)
    _check(out, torch.bfloat16, n, "stochastic_round_bf16_cuda: out")
    seed_t = _u32_seed(seed, x.device).reshape(1)
    seg, n_seg, base, modulus = None, 0, 0, 0
    if index is not None:
        seg = index.segments
        if not (seg.is_cuda and seg.dtype == torch.int64 and seg.dim() == 2
                and seg.shape[1] == 4 and seg.is_contiguous()):
            raise ValueError("stochastic_round_bf16_cuda: index.segments "
                             "must be a contiguous int64 [n, 4] CUDA tensor")
        n_seg, base, modulus = seg.shape[0], index.base, index.modulus
    if n:
        _launch("sr_bf16", [ctypes.c_void_p] * 4
                + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
                + _ARGS_TAIL,
                x.data_ptr(), out.data_ptr(), seed_t.data_ptr(),
                None if seg is None else seg.data_ptr(), n_seg, base,
                modulus, n, _n_valid(x, n_valid), _grid_cap(x),
                x.device.index,
                torch.cuda.current_stream(x.device).cuda_stream)
        stochastic_round_bf16_cuda.launches += 1
    return out


def quantize_int8_cuda(x: torch.Tensor, n_valid: Optional[int] = None,
                       scale: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper int8 quantize kernel: (int8[padded], f32[rows]);
    with ``scale`` it quantizes on those per-row scales (returned as
    given) and reduces no row."""
    n = x.numel()
    rows = _rows(x)
    _check(x, torch.float32, n, "quantize_int8_cuda: x")
    q = torch.empty((n,), dtype=torch.int8, device=x.device)
    if scale is None:
        out, given = torch.empty((rows,), dtype=torch.float32,
                                 device=x.device), None
    else:
        _check(scale, torch.float32, rows, "quantize_int8_cuda: scale")
        out = given = scale
    if n:
        _launch("quantize_int8", [ctypes.c_void_p] * 4 + _ARGS_TAIL,
                x.data_ptr(), None if given is None else given.data_ptr(),
                q.data_ptr(), out.data_ptr(), n,
                _n_valid(x, n_valid), _grid_cap(x), x.device.index,
                torch.cuda.current_stream(x.device).cuda_stream)
        quantize_int8_cuda.launches += 1
    return q, out


def dequantize_int8_cuda(q: torch.Tensor, scale: torch.Tensor,
                         n_valid: Optional[int] = None, *,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the Hopper int8 dequantize kernel; writes ``out`` (a new f32
    buffer when None)."""
    n = q.numel()
    rows = _rows(q)
    _check(q, torch.int8, n, "dequantize_int8_cuda: q")
    _check(scale, torch.float32, rows, "dequantize_int8_cuda: scale")
    if out is None:
        out = torch.empty((n,), dtype=torch.float32, device=q.device)
    _check(out, torch.float32, n, "dequantize_int8_cuda: out")
    if n:
        _launch("dequantize_int8", [ctypes.c_void_p] * 3 + _ARGS_TAIL,
                q.data_ptr(), scale.data_ptr(), out.data_ptr(), n,
                _n_valid(q, n_valid), _grid_cap(q), q.device.index,
                torch.cuda.current_stream(q.device).cuda_stream)
        dequantize_int8_cuda.launches += 1
    return out


stochastic_round_bf16_cuda.launches = 0
quantize_int8_cuda.launches = 0
dequantize_int8_cuda.launches = 0


# ---------------------------------------------------------------------------
# dispatchers
# ---------------------------------------------------------------------------
def stochastic_round_bf16(x: torch.Tensor, seed, n_valid: Optional[int] = None,
                          *, impl: Optional[str] = None,
                          out: Optional[torch.Tensor] = None,
                          index: Optional[HashIndex] = None) -> torch.Tensor:
    """f32[padded] -> bf16[padded], unbiased seeded rounding, zero tail
    (written into ``out`` when given); ``index`` gives the positions the
    hash reads where they are not the buffer's own (``HashIndex``)."""
    if _resolve(impl, x) == "cuda":
        return stochastic_round_bf16_cuda(x, seed, n_valid, out=out,
                                          index=index)
    y = stochastic_round_bf16_plain(x, seed, n_valid, index)
    return y if out is None else out.copy_(y)


def quantize_int8(x: torch.Tensor, n_valid: Optional[int] = None, *,
                  impl: Optional[str] = None,
                  scale: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32[padded] -> (int8[padded], f32[rows] blockwise scales).
    ``scale`` (f32[rows]) supplies the scales, so that ranks which agreed
    them beforehand quantize shared rows alike; without it each row's
    scale is its own absmax / 127, bitwise JAX's ``ref.py``."""
    if _resolve(impl, x) == "cuda":
        return quantize_int8_cuda(x, n_valid, scale)
    return quantize_int8_plain(x, n_valid, scale)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    n_valid: Optional[int] = None, *,
                    impl: Optional[str] = None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(int8[padded], f32[rows]) -> f32[padded], zero tail (written into
    ``out`` when given)."""
    if _resolve(impl, q) == "cuda":
        return dequantize_int8_cuda(q, scale, n_valid, out=out)
    y = dequantize_int8_plain(q, scale, n_valid)
    return y if out is None else out.copy_(y)


def quantize_dequantize_int8(x: torch.Tensor, n_valid: Optional[int] = None,
                             *, impl: Optional[str] = None,
                             out: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Project onto the blockwise int8 grid (the int8 wire edge); with
    ``out=x`` the result replaces the buffer in place."""
    q, s = quantize_int8(x, n_valid, impl=impl)
    return dequantize_int8(q, s, n_valid, impl=impl, out=out)


def cast_compute(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """THE compute/wire dtype cast: a bare ``.to`` (identity for None or
    the tensor's own dtype)."""
    if dtype is None or x.dtype == dtype:
        return x
    return x.to(dtype)


def wire_seed(step, bucket: int) -> torch.Tensor:
    """Deterministic per-(step, bucket) stochastic-rounding seed,
    ``u32(step) * 2654435761 + (bucket + 1)`` wrapping in uint32, as an
    int64 tensor on the step's device (same on every replica)."""
    s = _u32_seed(step, step.device if isinstance(step, torch.Tensor)
                  else "cpu")
    return (s * _SEED_MUL + (bucket + 1)) & _M32
