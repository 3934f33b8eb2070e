"""Recurrent sequence mixers of the port: the RG-LRU block (Griffin /
RecurrentGemma) and the RWKV-6 (Finch) time-mix and channel-mix, with
their decode state.

Port of ``repro/models/recurrent.py``.  The decode state is O(1) a token:
the RG-LRU's carried h [B, W] (f32) and the causal conv's last K-1 inputs
[B, K-1, W] (``make_rglru_state``); RWKV-6's per-head matrix state
[B, H, D, D] (f32) and the last token of the time-mix's and of the
channel-mix's input (``make_rwkv_state``).  Given a state, each mixer
starts from it (``h0`` into the scan, ``s0`` into the WKV, the carried
inputs ahead of the conv and the token shift) and writes the new one into
it in place.

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

Over the 'model' mesh axis (a ``ModelParallel``, ``sharding/tp.py``), where
JAX's constraints over 'lru', 'heads' and 'ff' have XLA split them, the
training paths run tensor-parallel, the input entering through
``copy_in`` and the row-parallel output projection's partial sums
all-reduced (``reduce_out``):

* RG-LRU: this rank's 'lru' channels of ``wx`` / ``wgate``, the conv,
  ``a_param`` and the scan on them; its gate blocks, or, where the 'lru'
  split falls inside a block (the gates stay whole), the whole blocks
  covering its channels over a gathered conv output.
* RWKV-6 time-mix: this rank's heads of r / k / v / g, the decay, the
  bonus ``u``, the WKV and the group norm; the ddlerp runs whole on every
  rank, its leaves, ``w0``, the decay LoRA and the group norm's scale and
  bias entering through ``copy_in`` (their gradients cover this rank's
  heads only).  Channel-mix: ``wk``'s 'ff' columns, ``wv``'s rows.

Without a model axis the same bodies run over every channel and head:
the helpers then take the whole span and issue nothing.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru import rglru_scan
from repro_torch.kernels.rwkv6 import rwkv6_mix
from repro_torch.models.common import dense_init, tp_columns
from repro_torch.sharding.tp import (
    copy_in,
    covering,
    gather,
    owned_part,
    reduce_out,
)

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


def make_rglru_state(cfg, batch: int, *, lead: Sequence[int] = (),
                     device="cuda", dtype=torch.float32) -> Dict:
    w = cfg.resolved_lru_width
    return {
        "h": torch.zeros((*lead, batch, w), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((*lead, batch, cfg.conv1d_width - 1, w),
                            dtype=dtype, device=device),
    }


def _causal_conv1d(x: torch.Tensor, conv_w: torch.Tensor,
                   conv_b: torch.Tensor, state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel causal conv. x [B,S,W]; conv_w [K,W]. state: the last K-1
    inputs from the previous call (decode) or None (train, zero history).
    Returns (out, the new state: the last K-1 inputs of history + x)."""
    k = conv_w.shape[0]
    if state is None:
        hist = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    else:
        hist = state.to(x.dtype)
    xx = torch.cat([hist, x], dim=1)  # [B, S+K-1, W]
    out = sum(xx[:, i:i + x.shape[1]] * conv_w[i][None, None, :]
              for i in range(k))
    new_state = xx[:, xx.shape[1] - (k - 1):]
    return out + conv_b[None, None, :], new_state


def _block_diag_gate(y: torch.Tensor, w_gate: torch.Tensor,
                     heads: int) -> torch.Tensor:
    """y [B,S,W] -> sigmoid(block-diag proj). w_gate [H, bh, bh]."""
    b, s, w = y.shape
    yh = y.reshape(b, s, heads, w // heads)
    g = torch.einsum("bshi,hij->bshj", yh, w_gate)
    return torch.sigmoid(g.reshape(b, s, w).float())


def _refuse_state(tp, state) -> None:
    if tp is not None and state is not None:
        raise NotImplementedError(
            "a recurrent decode state sharded over the 'model' axis (JAX's "
            "cache_specs) is not ported: ROADMAP item 8.4")


def _rglru_gates(p: Dict, y: torch.Tensor, heads: int, width: int, tp
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence and input gates of this rank's channels ``y`` [B, S,
    W / model]: over its gate blocks where they split like the channels,
    else over the whole blocks covering its channels (the conv output
    gathered over 'model', the whole gate leaves through ``copy_in``),
    sliced to its channels (all of them, without ``tp``)."""
    bh = width // heads
    c0, c1, b0, b1 = covering(tp, "lru", width, bh)
    if tp is not None and not tp.split("heads", heads):
        y = gather(y, tp, dim=-1)[..., b0 * bh:b1 * bh]
    return tuple(
        _block_diag_gate(y, owned_part(p[name], "heads", heads, b0, b1, tp),
                         b1 - b0)[..., c0 - b0 * bh:c1 - b0 * bh]
        for name in ("w_rgate", "w_igate"))


def apply_rglru(p: Dict, x: torch.Tensor, *, cfg,
                state: Optional[Dict] = None,
                scan_impl: Optional[str] = None, tp=None) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d]; ``state`` (``make_rglru_state``) is read
    and written in place.  ``tp`` (a ``ModelParallel``) runs it over this
    rank's 'lru' channels where 'lru' splits (else whole on every rank,
    as XLA leaves it)."""
    _refuse_state(tp, state)
    if tp is not None and not tp.split("lru", cfg.resolved_lru_width):
        tp = None
    x = copy_in(x, tp)
    heads = cfg.n_heads
    gate = F.gelu((x @ p["wgate"]).float(), approximate="tanh")
    y, new_conv = _causal_conv1d(x @ p["wx"], p["conv_w"], p["conv_b"],
                                 state["conv"] if state else None)
    # the recurrence and input gates
    r, i = _rglru_gates(p, y, heads, cfg.resolved_lru_width, tp)
    a_param = p["a_param"].float()
    # jax.nn.softplus is logaddexp(x, 0) (F.softplus returns x above 20)
    softplus = torch.logaddexp(a_param, torch.zeros_like(a_param))
    log_a = -_C_RGLRU * softplus * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) normalizer, computed stably via log
    norm = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    bt = norm * (i * y.float())
    h, h_final = rglru_scan(bt, a, state["h"] if state else None,
                            impl=scan_impl)
    if state:
        state["h"].copy_(h_final)
        state["conv"].copy_(new_conv)
    return reduce_out((h * gate).to(x.dtype) @ p["wo"], tp)


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


def make_rwkv_state(cfg, batch: int, *, lead: Sequence[int] = (),
                    device="cuda", dtype=torch.float32) -> Dict:
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    return {
        "s": torch.zeros((*lead, batch, h, hd, hd), dtype=torch.float32,
                         device=device),
        # the last token of the time mix's and of the channel mix's input
        "shift_tm": torch.zeros((*lead, batch, d), dtype=dtype,
                                device=device),
        "shift_cm": torch.zeros((*lead, batch, d), dtype=dtype,
                                device=device),
    }


def _token_shift(x: torch.Tensor,
                 last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The previous token's features [B,S,d]: position 0 takes ``last``
    (zeros when None)."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([first.to(x.dtype), x[:, :-1]], dim=1)


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


def _rwkv_wkv_and_norm(p: Dict, x: torch.Tensor, r, k, v, w, u, g, *,
                       state: Optional[Dict], scan_impl: Optional[str]
                       ) -> torch.Tensor:
    """The WKV of r / k / v / w [B, S, H, D] with bonus ``u`` [H, D], the
    per-head group norm (population variance, eps 64e-5) with ``p``'s
    ``ln_scale`` / ``ln_bias`` over those heads' columns, gated by ``g``
    -> [B, S, H * D] in x's dtype; ``state``'s ``s`` and ``shift_tm`` are
    written in place."""
    b, s, h, hd = r.shape
    o, s_final = rwkv6_mix(r, k, v, w, u.float(),
                           state["s"] if state else None, impl=scan_impl)
    if state:
        state["s"].copy_(s_final)
        state["shift_tm"].copy_(x[:, -1, :])
    mean = torch.mean(o, dim=-1, keepdim=True)
    var = torch.var(o, dim=-1, keepdim=True, unbiased=False)
    o = (o - mean) * torch.rsqrt(var + 64e-5)
    o = o.reshape(b, s, h * hd) * p["ln_scale"].float() + p["ln_bias"].float()
    return o.to(x.dtype) * g


# the time-mix's leaves ``spec_tree`` keeps whole on every model rank; each
# meets this rank's heads only (through the ddlerp's five inputs, the decay
# or the group norm), so its gradient sums over 'model'
_RWKV_WHOLE = ("mu_base", "ddlerp_a", "ddlerp_b", "w0", "w_lora_a",
               "w_lora_b", "ln_scale", "ln_bias")


def apply_rwkv_timemix(p: Dict, x: torch.Tensor, *, cfg,
                       state: Optional[Dict] = None,
                       scan_impl: Optional[str] = None,
                       tp=None) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d]; ``state`` (``make_rwkv_state``): its
    ``s`` and ``shift_tm`` are read and written in place.  ``tp`` (a
    ``ModelParallel``) runs it over the heads this rank owns: the output
    columns of its rows of ``wo`` (its shard where 'heads' splits, else
    its share of whole heads) and the whole heads ``[h0, h1)`` covering
    them."""
    _refuse_state(tp, state)
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    o0, o1, h0, h1 = covering(tp, "heads", d, hd)
    c0, c1, n = h0 * hd, h1 * hd, h1 - h0
    xc = copy_in(x, tp)
    whole = {key: copy_in(p[key], tp) for key in _RWKV_WHOLE}
    prev = _token_shift(xc, state["shift_tm"] if state else None)
    xr, xk, xv, xw, xg = _ddlerp(whole, xc, prev)
    cols = lambda xi, key, name: tp_columns(xi, p[key], name, d, c0, c1, tp)
    r = cols(xr, "wr", "heads").reshape(b, s, n, hd)
    k = cols(xk, "wk", "kv").reshape(b, s, n, hd)
    v = cols(xv, "wv", "kv").reshape(b, s, n, hd)
    g = F.silu(cols(xg, "wg", "heads"))
    w_log = whole["w0"][c0:c1].float() + (
        torch.tanh(xw @ whole["w_lora_a"])
        @ whole["w_lora_b"][:, c0:c1]).float()
    w = torch.exp(-torch.exp(w_log)).reshape(b, s, n, hd)
    u = owned_part(p["u"], "heads", h, h0, h1, tp)
    norm = {key: whole[key][c0:c1] for key in ("ln_scale", "ln_bias")}
    o = _rwkv_wkv_and_norm(norm, x, r, k, v, w, u, g, state=state,
                           scan_impl=scan_impl)[..., o0 - c0:o1 - c0]
    wo = owned_part(p["wo"], "heads", d, o0, o1, tp)
    return reduce_out(o @ wo, tp)


def init_rwkv_channelmix(generator, cfg, *, lead: Sequence[int] = (),
                         device="cuda", dtype=torch.float32) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(lead=lead, device=device, dtype=dtype)
    return {
        "mu_k": (_uniform(generator, (*lead, d), device) * 0.5).to(dtype),
        "wk": dense_init(generator, d, f, **kw),
        "wv": dense_init(generator, f, d, **kw),
    }


def apply_rwkv_channelmix(p: Dict, x: torch.Tensor, *, cfg=None,
                          state: Optional[Dict] = None,
                          tp=None) -> torch.Tensor:
    """Token-shifted squared-relu MLP: x [B, S, d] -> [B, S, d];
    ``state``'s ``shift_cm`` is read and written in place.  ``tp`` (a
    ``ModelParallel``) with ``cfg``: where 'ff' splits, ``wk`` by this
    rank's columns, ``wv`` by its rows, ``mu_k`` whole through
    ``copy_in`` (else whole on every rank)."""
    _refuse_state(tp, state)
    if tp is not None and not tp.split("ff", cfg.d_ff):
        tp = None
    xc = copy_in(x, tp)
    prev = _token_shift(xc, state["shift_cm"] if state else None)
    xk = xc + (prev - xc) * copy_in(p["mu_k"], tp)[None, None]
    out = torch.square(torch.relu(xk @ p["wk"])) @ p["wv"]
    if state:
        state["shift_cm"].copy_(x[:, -1, :])
    return reduce_out(out, tp)
