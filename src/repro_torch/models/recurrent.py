"""RG-LRU recurrent block of the port (Griffin / RecurrentGemma), train path.

Port of the RG-LRU half of ``repro/models/recurrent.py`` without the decode
state (the conv ring and the carried h come with serving): input and gate
projections, a per-channel causal conv1d over zero history, block-diagonal
recurrence and input gates, the decay ``a = exp(-c softplus(L) r)`` with
its ``sqrt(1 - a^2)`` normaliser, then the scan ``h_t = a_t h_{t-1} + b_t``
through ``kernels/rglru`` and the gated output projection.  The parameter
names and shapes are the JAX package's; ``lead`` prepends the stacked
per-period axis.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru import rglru_scan
from repro_torch.models.common import dense_init

_C_RGLRU = 8.0  # the paper's fixed scalar c


def _drawn(shape, device, fill) -> torch.Tensor:
    """An f32 tensor of ``shape`` filled by ``fill`` (nothing on meta)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        fill(t)
    return t


def init_rglru_block(generator, cfg, *, lead: Sequence[int] = (),
                     device="cuda", dtype=torch.float32) -> Dict:
    d = cfg.d_model
    w = cfg.resolved_lru_width
    heads = cfg.n_heads
    bh = w // heads
    kw = dict(lead=lead, device=device, dtype=dtype)
    # Lambda init so that a = exp(-c*softplus(L)*r) starts near 0.9..0.999
    lam = _drawn((*lead, w), device,
                 lambda t: t.uniform_(0.9, 0.999, generator=generator))
    a_param = torch.log(torch.exp(-torch.log(lam) / _C_RGLRU) - 1.0)
    normal = lambda shape, std: _drawn(
        shape, device, lambda t: t.normal_(0.0, std, generator=generator))
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
