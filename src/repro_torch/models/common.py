"""Shared model primitives: norms, RoPE, activations, initializers.

Port of ``repro/models/common.py``: plain functions over explicit
parameter dicts of torch tensors, computing in f32 in the same order as
the JAX package.  Initializers draw from a ``torch.Generator`` (the
numbers differ from ``jax.random``; parity tests carry JAX params across
with ``repro_torch.convert``).  ``matmul`` is ``@`` with jnp's dtype
promotion, which PyTorch's products lack.  ``apply_ffn`` runs
tensor-parallel over the 'model' axis when given a ``ModelParallel``
(``sharding/tp.py``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.sharding.tp import copy_in, reduce_out, vocab_parallel_nll


# ---------------------------------------------------------------------------
# Initializers (``lead`` prepends the stacked per-period axis)
# ---------------------------------------------------------------------------
def _trunc_normal(shape, std, generator, device, dtype):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        t.mul_(std)
    return t.to(dtype)


def dense_init(generator, d_in: int, d_out: int, *, lead: Sequence[int] = (),
               device="cuda", dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init (std = 1/sqrt(d_in))."""
    return _trunc_normal((*lead, d_in, d_out), 1.0 / math.sqrt(d_in),
                         generator, device, dtype)


def embed_init(generator, vocab: int, d: int, *, device="cuda",
               dtype=torch.float32) -> torch.Tensor:
    return _trunc_normal((vocab, d), 0.02, generator, device, dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def init_norm(kind: str, d: int, *, lead: Sequence[int] = (), device="cuda",
              dtype=torch.float32):
    z = lambda: torch.zeros((*lead, d), dtype=dtype, device=device)
    if kind == "rmsnorm":
        return {"scale": z()}  # gemma-style (1+scale)
    return {"scale": z() + 1.0, "bias": z()}


def apply_norm(p, x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * (1.0 + p["scale"].float())
        return y.to(x.dtype)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def rms_norm_per_head(x: torch.Tensor, scale: Optional[torch.Tensor],
                      eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: RMS-normalize the last (head) dim. scale: [head_dim]."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * (1.0 + scale.float())
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device="cuda") -> torch.Tensor:
    """[head_dim/2] inverse frequencies."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, n_heads, head_dim]; positions: [..., seq].

    Rotates the half-split pairs (x[i], x[i + half]), exactly as the JAX
    package's code does (its docstring says interleaved pairs; the code
    is what the reference computes)."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs     # [..., seq, half]
    angles = angles[..., None, :]                     # broadcast over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------
def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the dtype jnp promotes the pair to: an f32 activation
    beside a bf16 weight (an encoder over the f32 stub memory, the
    cross-attention K/V of it, under bf16 params) multiplies in f32, where
    PyTorch would raise; a pair of one dtype multiplies as it is."""
    if x.dtype == w.dtype:
        return x @ w
    dt = torch.result_type(x, w)
    return x.to(dt) @ w.to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def gated_act(kind: str, gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    if kind == "silu":
        return F.silu(gate) * up
    if kind == "gelu":
        return F.gelu(gate, approximate="tanh") * up
    raise ValueError(kind)


def init_ffn(generator, cfg, *, lead: Sequence[int] = (), device="cuda",
             dtype=torch.float32):
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(lead=lead, device=device, dtype=dtype)
    if cfg.ffn_activation in ("silu", "gelu"):
        return {
            "gate": dense_init(generator, d, f, **kw),
            "up": dense_init(generator, d, f, **kw),
            "down": dense_init(generator, f, d, **kw),
        }
    return {
        "up": dense_init(generator, d, f, **kw),
        "down": dense_init(generator, f, d, **kw),
    }


def apply_ffn(p, x: torch.Tensor, cfg, tp=None) -> torch.Tensor:
    """With ``tp`` (a ``ModelParallel``) and the ff dim split over 'model':
    gate / up column-parallel on this rank's ff columns, down
    row-parallel, its partial sums all-reduced."""
    if tp is not None and tp.split("ff", cfg.d_ff):
        x = copy_in(x, tp)
        return reduce_out(apply_ffn(p, x, cfg), tp)
    if cfg.ffn_activation in ("silu", "gelu"):
        h = gated_act(cfg.ffn_activation, matmul(x, p["gate"]),
                      matmul(x, p["up"]))
    else:  # plain (non-gated) GELU MLP
        h = F.gelu(matmul(x, p["up"]), approximate="tanh")
    return matmul(h, p["down"])


def token_nll(logits: torch.Tensor, labels: torch.Tensor,
              tp=None) -> torch.Tensor:
    """Per-token ``logsumexp - gold`` of f32 ``logits`` [..., V]; with
    ``tp`` the logits are this rank's vocab slice (``vocab_parallel_nll``
    over 'model')."""
    if tp is not None:
        return vocab_parallel_nll(logits, labels, tp)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logz - gold


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       tp=None) -> torch.Tensor:
    """Mean token cross-entropy; logits [..., V], labels int [...] (``tp``:
    ``token_nll``'s)."""
    nll = token_nll(logits.float(), labels, tp)
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
