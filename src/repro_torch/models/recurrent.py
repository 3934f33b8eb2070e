"""Recurrent sequence mixers of the port, train path: the RG-LRU block
(Griffin / RecurrentGemma) and the RWKV-6 (Finch) time-mix and channel-mix.

Port of ``repro/models/recurrent.py`` without the decode state (the conv
ring, the carried h, the RWKV state and token-shift buffers come with
serving).

* RG-LRU: input and gate projections, a per-channel causal conv1d over zero
  history, block-diagonal recurrence and input gates, the decay
  ``a = exp(-c softplus(L) r)`` with its ``sqrt(1 - a^2)`` normaliser, then
  the scan ``h_t = a_t h_{t-1} + b_t`` through ``kernels/rglru`` and the
  gated output projection.
* RWKV-6 time-mix: token shift, the data-dependent lerp (ddlerp) of the
  five inputs, r/k/v/g projections, the decay ``w = exp(-exp(w0 + tanh(xw
  A) B))``, the WKV recurrence through ``kernels/rwkv6``, a per-head group
  norm and the gated output projection.  Channel-mix: token shift, then
  ``relu(xk wk)^2 wv``.  The head size is ``d_model // n_heads``, not
  ``cfg.head_dim``.

The parameter names and shapes are the JAX package's; ``lead`` prepends
the stacked per-period axis.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru import rglru_scan
from repro_torch.kernels.rwkv6 import rwkv6_mix
from repro_torch.models.common import dense_init

_C_RGLRU = 8.0  # the paper's fixed scalar c


def _drawn(shape, device, fill) -> torch.Tensor:
    """An f32 tensor of ``shape`` filled by ``fill`` (nothing on meta)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        fill(t)
    return t


def _uniform(generator, shape, device, lo=0.0, hi=1.0) -> torch.Tensor:
    return _drawn(shape, device,
                  lambda t: t.uniform_(lo, hi, generator=generator))


def _normal(generator, shape, device, std) -> torch.Tensor:
    return _drawn(shape, device,
                  lambda t: t.normal_(0.0, std, generator=generator))


def init_rglru_block(generator, cfg, *, lead: Sequence[int] = (),
                     device="cuda", dtype=torch.float32) -> Dict:
    d = cfg.d_model
    w = cfg.resolved_lru_width
    heads = cfg.n_heads
    bh = w // heads
    kw = dict(lead=lead, device=device, dtype=dtype)
    # Lambda init so that a = exp(-c*softplus(L)*r) starts near 0.9..0.999
    lam = _uniform(generator, (*lead, w), device, 0.9, 0.999)
    a_param = torch.log(torch.exp(-torch.log(lam) / _C_RGLRU) - 1.0)
    normal = lambda shape, std: _normal(generator, shape, device, std)
    return {
        "wx": dense_init(generator, d, w, **kw),
        "wgate": dense_init(generator, d, w, **kw),
        "conv_w": normal((*lead, cfg.conv1d_width, w), 0.1).to(dtype),
        "conv_b": torch.zeros((*lead, w), dtype=dtype, device=device),
        # block-diagonal gate projections: [heads, bh, bh]
        "w_rgate": normal((*lead, heads, bh, bh), 1 / math.sqrt(bh)).to(dtype),
        "w_igate": normal((*lead, heads, bh, bh), 1 / math.sqrt(bh)).to(dtype),
        "a_param": a_param.to(dtype),
        "wo": dense_init(generator, w, d, **kw),
    }


def _causal_conv1d(x: torch.Tensor, conv_w: torch.Tensor,
                   conv_b: torch.Tensor) -> torch.Tensor:
    """Per-channel causal conv over zero history. x [B,S,W]; conv_w [K,W]."""
    k = conv_w.shape[0]
    hist = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device)
    xx = torch.cat([hist, x], dim=1)  # [B, S+K-1, W]
    out = sum(xx[:, i:i + x.shape[1]] * conv_w[i][None, None, :]
              for i in range(k))
    return out + conv_b[None, None, :]


def _block_diag_gate(y: torch.Tensor, w_gate: torch.Tensor,
                     heads: int) -> torch.Tensor:
    """y [B,S,W] -> sigmoid(block-diag proj). w_gate [H, bh, bh]."""
    b, s, w = y.shape
    yh = y.reshape(b, s, heads, w // heads)
    g = torch.einsum("bshi,hij->bshj", yh, w_gate)
    return torch.sigmoid(g.reshape(b, s, w).float())


def apply_rglru(p: Dict, x: torch.Tensor, *, cfg,
                scan_impl: Optional[str] = None) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d]."""
    heads = cfg.n_heads
    gate = F.gelu((x @ p["wgate"]).float(), approximate="tanh")
    y = _causal_conv1d(x @ p["wx"], p["conv_w"], p["conv_b"])
    r = _block_diag_gate(y, p["w_rgate"], heads)          # recurrence gate
    i = _block_diag_gate(y, p["w_igate"], heads)          # input gate
    a_param = p["a_param"].float()
    # jax.nn.softplus is logaddexp(x, 0) (F.softplus returns x above 20)
    softplus = torch.logaddexp(a_param, torch.zeros_like(a_param))
    log_a = -_C_RGLRU * softplus * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) normalizer, computed stably via log
    norm = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    bt = norm * (i * y.float())
    h, _ = rglru_scan(bt, a, impl=scan_impl)
    return (h * gate).to(x.dtype) @ p["wo"]


# ---------------------------------------------------------------------------
# RWKV-6 (Finch)
# ---------------------------------------------------------------------------
_DDLERP_RANK = 32


def init_rwkv_timemix(generator, cfg, *, lead: Sequence[int] = (),
                      device="cuda", dtype=torch.float32) -> Dict:
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    kw = dict(lead=lead, device=device, dtype=dtype)
    uniform = lambda shape: _uniform(generator, shape, device)
    normal = lambda shape, std: _normal(generator, shape, device, std)
    return {
        # token-shift base mixes (mu_x for the shared ddlerp + per-proj mus)
        "mu_base": (uniform((*lead, 5, d)) * 0.5).to(dtype),
        # ddlerp low-rank adapters: A [d, 5*rank], B [5, rank, d]
        "ddlerp_a": dense_init(generator, d, 5 * _DDLERP_RANK, **kw),
        "ddlerp_b": normal((*lead, 5, _DDLERP_RANK, d), 0.01).to(dtype),
        "wr": dense_init(generator, d, d, **kw),
        "wk": dense_init(generator, d, d, **kw),
        "wv": dense_init(generator, d, d, **kw),
        "wg": dense_init(generator, d, d, **kw),
        # decay: w = exp(-exp(w0 + lora)); w0 init for half-life spread
        "w0": torch.linspace(-6.0, -0.5, d, device=device).to(dtype)
        .expand((*lead, d)).clone(),
        "w_lora_a": dense_init(generator, d, 64, **kw),
        "w_lora_b": normal((*lead, 64, d), 0.01).to(dtype),
        "u": normal((*lead, h, hd), 0.1).to(dtype),            # bonus
        "wo": dense_init(generator, d, d, **kw),
        # per-head groupnorm scale and bias
        "ln_scale": torch.ones((*lead, d), dtype=dtype, device=device),
        "ln_bias": torch.zeros((*lead, d), dtype=dtype, device=device),
    }


def _token_shift(x: torch.Tensor) -> torch.Tensor:
    """The previous token's features, zeros at position 0: [B,S,d]."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _ddlerp(p: Dict, x: torch.Tensor, prev: torch.Tensor):
    """Data-dependent lerp producing the 5 mixed inputs (r,k,v,w,g)."""
    dx = prev - x
    base = x[:, :, None, :] + dx[:, :, None, :] * p["mu_base"][None, None]
    # low-rank data-dependent adjustment
    lora = torch.tanh(x @ p["ddlerp_a"])                   # [B,S,5*rank]
    b, s, _ = lora.shape
    lora = lora.reshape(b, s, 5, _DDLERP_RANK)
    adj = torch.einsum("bsfr,frd->bsfd", lora, p["ddlerp_b"])
    mixed = base + dx[:, :, None, :] * adj                 # [B,S,5,d]
    return [mixed[:, :, j] for j in range(5)]


def apply_rwkv_timemix(p: Dict, x: torch.Tensor, *, cfg,
                       scan_impl: Optional[str] = None) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d]."""
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    xr, xk, xv, xw, xg = _ddlerp(p, x, _token_shift(x))
    r = (xr @ p["wr"]).reshape(b, s, h, hd)
    k = (xk @ p["wk"]).reshape(b, s, h, hd)
    v = (xv @ p["wv"]).reshape(b, s, h, hd)
    g = F.silu(xg @ p["wg"])
    w_log = p["w0"].float() + (
        torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]).float()
    w = torch.exp(-torch.exp(w_log)).reshape(b, s, h, hd)
    o, _ = rwkv6_mix(r, k, v, w, p["u"].float(), impl=scan_impl)
    # per-head group norm (population variance, eps 64e-5)
    mean = torch.mean(o, dim=-1, keepdim=True)
    var = torch.var(o, dim=-1, keepdim=True, unbiased=False)
    o = (o - mean) * torch.rsqrt(var + 64e-5)
    o = o.reshape(b, s, d) * p["ln_scale"].float() + p["ln_bias"].float()
    return (o.to(x.dtype) * g) @ p["wo"]


def init_rwkv_channelmix(generator, cfg, *, lead: Sequence[int] = (),
                         device="cuda", dtype=torch.float32) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(lead=lead, device=device, dtype=dtype)
    return {
        "mu_k": (_uniform(generator, (*lead, d), device) * 0.5).to(dtype),
        "wk": dense_init(generator, d, f, **kw),
        "wv": dense_init(generator, f, d, **kw),
    }


def apply_rwkv_channelmix(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Token-shifted squared-relu MLP: x [B, S, d] -> [B, S, d]."""
    xk = x + (_token_shift(x) - x) * p["mu_k"][None, None]
    return torch.square(torch.relu(xk @ p["wk"])) @ p["wv"]
