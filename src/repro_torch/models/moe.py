"""Mixture-of-Experts FFN of the port, with capacity-based token dispatch.

Port of ``repro/models/moe.py``: an f32 router softmax, top-k with ties to
the lower expert index (``jax.lax.top_k``'s order), renormalised weights,
the Switch-style load-balance aux loss, per-expert queues of static
capacity ``ceil(T k / E * capacity_factor)`` filled in token-major
(token, choice) order by an exclusive cumsum, overflow dropped (the
residual carries those tokens), the routed experts' SwiGLU as batched
products over [E, C, .] (JAX computes these outside any Pallas kernel),
the weighted combine in f32, and the shared experts as a dense FFN on
every token.

Determinism.  JAX's dispatch gather ``xp[slot_token]`` and its combine
``out.at[slot_token].add(...)`` would be, in PyTorch, an index gather
whose backward sums with ``index_add_`` and a ``scatter_add_``: on CUDA
both sum colliding rows with float atomics, in whatever order they land.
Here every routing move is a gather by row (:class:`_RowGather`) whose
backward is again a gather, along the inverse map, summed in a fixed
order: the dispatch's backward adds a token's k slot gradients in choice
order, and the combine adds a token's k weighted expert rows in choice
order.  No float sum depends on the order of atomics, so two runs on the
card give the same bits.

Over the 'model' axis (``tp``, a ``sharding.tp.ModelParallel``) it runs
expert parallelism in tensor-parallel form, as JAX's constraints over
'experts' have XLA run it.  Every rank holds the whole token set (the
residual stream is replicated over 'model'), so the router, the softmax,
the top-k, the aux loss, the capacity and ``route`` run whole and alike on
every rank, and the drop set is JAX's.  Each rank dispatches to, runs and
combines only its experts' slots ``[e0 * cap, e1 * cap)``
(``sharding.tp.expert_span``; where 'experts' does not divide by the model
size, its share of whole experts from the whole leaves, entered through
``copy_in``), the shared experts over their ff columns, and one
``reduce_out`` sums the routed and shared partial outputs.  The tokens
enter the dispatch and the shared experts, and the routing weights the
combine, through ``copy_in``: each rank's gradient of them covers its
experts only, while the router and the aux get one whole gradient on
every rank.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, gated_act
from repro_torch.sharding.tp import copy_in, expert_span, owned_part, reduce_out


def _normal(generator, shape, std, device, dtype):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        t.normal_(0.0, 1.0, generator=generator).mul_(std)
    return t.to(dtype)


def init_moe(generator, cfg, *, lead: Sequence[int] = (), device="cuda",
             dtype=torch.float32) -> Dict:
    """The JAX tree: ``router`` [d, E], ``experts/{gate, up, down}``
    [E, d, de] / [E, de, d] (normal, std 1/sqrt of the fan-in) and, with
    shared experts, ``shared/{gate, up, down}`` of width de x n_shared."""
    me = cfg.moe
    d = cfg.d_model
    de = me.d_expert or cfg.d_ff
    e = me.n_experts
    kw = dict(lead=lead, device=device, dtype=dtype)
    p = {
        "router": dense_init(generator, d, e, **kw),
        "experts": {
            "gate": _normal(generator, (*lead, e, d, de), 1.0 / math.sqrt(d),
                            device, dtype),
            "up": _normal(generator, (*lead, e, d, de), 1.0 / math.sqrt(d),
                          device, dtype),
            "down": _normal(generator, (*lead, e, de, d), 1.0 / math.sqrt(de),
                            device, dtype),
        },
    }
    if me.n_shared_experts:
        ds = de * me.n_shared_experts
        p["shared"] = {
            "gate": dense_init(generator, d, ds, **kw),
            "up": dense_init(generator, d, ds, **kw),
            "down": dense_init(generator, ds, d, **kw),
        }
    return p


def _rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of ``src`` [N, d]; index N reads a row of zeros."""
    pad = torch.cat([src, src.new_zeros((1, src.shape[1]))])
    return pad.index_select(0, idx)


class _RowGather(torch.autograd.Function):
    """out[i] = src[idx[i]] (idx == len(src): zeros).  ``inv`` [len(src),
    m] lists, for each source row, the output rows that read it (len(out)
    where fewer than m do); the backward gathers those rows' gradients and
    sums them in column order, with no scatter."""

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(inv)
        return _rows(src, idx)

    @staticmethod
    def backward(ctx, grad):
        (inv,) = ctx.saved_tensors
        n, m = inv.shape
        parts = _rows(grad.contiguous(), inv.reshape(-1)).reshape(
            n, m, grad.shape[-1])
        acc = parts[:, 0]
        for j in range(1, m):
            acc = acc + parts[:, j]
        return acc, None, None


def top_k_lower_first(probs: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the k largest values in
    descending order, ties to the lower index (a stable descending sort;
    ``torch.topk`` leaves the order among equal values open)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(top_e: torch.Tensor, n_experts: int, cap: int):
    """Capacity dispatch of the [T, k] choices: each (token, choice) takes
    the next place of its expert's queue in token-major order (exclusive
    cumsum); places >= ``cap`` are dropped.  Returns ``slot_token``
    [E * cap] (the token in each slot, T where empty) and ``choice_slot``
    [T, k] (each choice's slot, E * cap where dropped)."""
    t, k = top_e.shape
    choice_e = top_e.reshape(-1)                              # [T*k]
    onehot = F.one_hot(choice_e, n_experts)                   # [T*k, E]
    pos = torch.sum((torch.cumsum(onehot, 0) - onehot) * onehot, -1)
    kept = pos < cap
    slot = torch.where(kept, choice_e * cap + pos,
                       torch.full_like(pos, n_experts * cap))
    # every kept slot is written by exactly one choice; the dropped ones
    # all land on the discarded last entry
    choice_t = torch.arange(t, device=top_e.device).repeat_interleave(k)
    slot_token = torch.full((n_experts * cap + 1,), t, dtype=torch.long,
                            device=top_e.device)
    slot_token.scatter_(0, slot, torch.where(kept, choice_t,
                                             torch.full_like(choice_t, t)))
    return slot_token[:-1], slot.reshape(t, k)


def _inverse(slot: torch.Tensor, n_slots: int) -> torch.Tensor:
    """[n_slots, 1]: the flat (token, choice) index that fills each slot,
    T * k where none does."""
    n = slot.numel()
    inv = torch.full((n_slots + 1,), n, dtype=torch.long, device=slot.device)
    inv.scatter_(0, slot.reshape(-1), torch.arange(n, device=slot.device))
    inv[n_slots] = n
    return inv[:-1, None]


def _local(idx: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Indices into ``[lo, hi)`` made local to it; the others (and the
    dropped sentinel) become ``hi - lo``, which reads a row of zeros."""
    inside = (idx >= lo) & (idx < hi)
    return torch.where(inside, idx - lo, torch.full_like(idx, hi - lo))


def apply_moe(p: Dict, x: torch.Tensor, *, cfg,
              capacity_factor: float = 1.25, tp=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (output [B, S, d], aux load-balance loss, f32 0-d);
    ``tp`` (a ``ModelParallel``) runs this rank's experts only."""
    me = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = me.n_experts, me.experts_per_token
    xt = x.reshape(t, d)

    logits = (xt @ p["router"]).float()                       # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k_lower_first(probs, k)                # [T, k]
    top_p = top_p / torch.clamp(torch.sum(top_p, -1, keepdim=True), min=1e-9)

    # load-balance auxiliary loss (Switch-style); density carries no grad
    density = torch.mean(torch.sum(F.one_hot(top_e, e).float(), dim=1), dim=0)
    mean_prob = torch.mean(probs, dim=0)
    aux = me.router_aux_coef * e * torch.sum(density / k * mean_prob)

    cap = int(max(1, math.ceil(t * k / e * capacity_factor)))
    slot_token, choice_slot = route(top_e, e, cap)
    # this rank's experts and their slots [s0, s1)
    e0, e1 = expert_span(tp, e)
    s0, s1 = e0 * cap, e1 * cap
    mine = _local(choice_slot, s0, s1)                        # [T, k]
    xc = copy_in(xt, tp)
    # dispatch: each slot reads its token (empty: zeros); a token's
    # gradient sums its k slot gradients in choice order
    xe = _RowGather.apply(xc, slot_token[s0:s1], mine).reshape(
        e1 - e0, cap, d)

    ex = {name: owned_part(w, "experts", e, e0, e1, tp)
          for name, w in p["experts"].items()}
    gate = torch.bmm(xe, ex["gate"])
    up = torch.bmm(xe, ex["up"])
    act = (gated_act(cfg.ffn_activation, gate, up)
           if cfg.ffn_activation in ("silu", "gelu")
           else F.gelu(up, approximate="tanh"))
    ye = torch.bmm(act, ex["down"]).reshape(s1 - s0, d)      # [E*C, d]

    # combine: each choice reads its slot's output (another rank's or
    # dropped: zeros), the k weighted rows summed in choice order in f32
    got = _RowGather.apply(ye, mine.reshape(-1),
                           _inverse(choice_slot, e * cap)[s0:s1]
                           ).reshape(t, k, d)
    w = copy_in(top_p, tp)
    y = got[:, 0] * w[:, :1]
    for j in range(1, k):
        y = y + got[:, j] * w[:, j:j + 1]
    y = y.float().to(x.dtype)

    if me.n_shared_experts:
        sh = p["shared"]
        ds = (me.d_expert or cfg.d_ff) * me.n_shared_experts
        if tp is None or tp.split("ff", ds):       # this rank's ff columns
            y = y + gated_act(cfg.ffn_activation, xc @ sh["gate"],
                              xc @ sh["up"]) @ sh["down"]
        else:          # whole on every rank: its own gradient, after the sum
            y = reduce_out(y, tp) + gated_act(
                cfg.ffn_activation, xt @ sh["gate"], xt @ sh["up"]
            ) @ sh["down"]
            return y.reshape(b, s, d), aux
    return reduce_out(y, tp).reshape(b, s, d), aux
