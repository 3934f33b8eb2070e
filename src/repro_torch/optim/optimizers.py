"""Optimizers on parameter trees (the per-leaf reference of the port).

Port of ``repro/optim/optimizers.py``: the same ``OptimizerSpec``, the
same per-leaf hyperparameter segments (``leaf_hparams``) and the same
update math in the same order, on torch tensors.  The fused bucket
update (``kernels/bucket_update``) is tested against ``apply_updates``.

DeFT's update with a merged gradient of k batches is gradient
accumulation: ``apply_updates(..., grad_scale=1/(n_dp*k))``; the step
counter advances once per applied update.  A param leaf keeps its dtype:
the update runs in f32 and casts back, as JAX's does for non-f32 resident
params.  ``apply_updates_`` is its in-place twin, bitwise equal.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    name: str                       # 'adamw' | 'sgd'
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9           # sgd only
    grad_clip: float = 1.0          # global-norm clip; 0 disables
    # 'all' decays every leaf; 'matrix' only ndim >= 2 leaves
    decay_mask: str = "all"
    # lr multiplier for ndim < 2 leaves (norms/biases); 1.0 = no-op
    ndim1_lr_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class SegmentHParams:
    """Static optimizer hyperparameters of one parameter leaf — the
    segment metadata the fused bucket update consumes."""

    lr_scale: float
    weight_decay: float


def leaf_hparams(spec: OptimizerSpec, shapes) -> Tuple[SegmentHParams, ...]:
    """Per-leaf (lr_scale, weight_decay) from the spec's segment rules;
    ``shapes`` are leaf shapes (or tensors) in tree_flatten order."""
    out = []
    for s in shapes:
        shape = tuple(getattr(s, "shape", s))
        ndim = len(shape)
        wd = spec.weight_decay
        if spec.decay_mask == "matrix" and ndim < 2:
            wd = 0.0
        elif spec.decay_mask not in ("all", "matrix"):
            raise ValueError(f"unknown decay_mask {spec.decay_mask!r}")
        scale = spec.ndim1_lr_scale if ndim < 2 else 1.0
        out.append(SegmentHParams(lr_scale=scale, weight_decay=wd))
    return tuple(out)


def adamw(lr: float = 1e-3, **kw) -> OptimizerSpec:
    return OptimizerSpec("adamw", lr=lr, **kw)


def sgd_momentum(lr: float = 1e-2, momentum: float = 0.9, **kw) -> OptimizerSpec:
    return OptimizerSpec("sgd", lr=lr, momentum=momentum, **kw)


def init_opt_state(spec: OptimizerSpec, params) -> Dict[str, Any]:
    """f32 moment trees shaped like ``params`` and an int32 step counter
    on the params' device."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else "cpu"
    zeros = lambda: tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params,
    )
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if spec.name == "adamw":
        return {"step": step, "m": zeros(), "v": zeros()}
    if spec.name == "sgd":
        return {"step": step, "m": zeros()}
    raise ValueError(spec.name)


def global_norm(tensors) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in tensors]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_factor(spec: OptimizerSpec, gn: torch.Tensor) -> torch.Tensor:
    """min(1, grad_clip / max(gn, 1e-12)) as an f32 device scalar (a true
    division: ``float / tensor`` would multiply by a reciprocal)."""
    return torch.clamp(
        gn.new_tensor(spec.grad_clip) / torch.clamp(gn, min=1e-12), max=1.0
    )


def apply_updates(
    spec: OptimizerSpec,
    params,
    grads,
    state: Dict[str, Any],
    *,
    grad_scale=1.0,
    lr_scale=1.0,
    norm=global_norm,
) -> Tuple[Any, Dict[str, Any]]:
    """One optimizer step (pure: returns new params and state).
    ``grad_scale`` multiplies the raw gradient first; ``norm`` of the
    scaled leaves is the clip's global norm (a model-parallel step's sums
    its shards over 'model', ``sharding.tp.global_norm``)."""
    g = [x.float() * grad_scale for x in tree_leaves(grads)]
    if spec.grad_clip:
        clip = clip_factor(spec, norm(g))
        g = [x * clip for x in g]
    step = state["step"] + 1
    lr = spec.lr * lr_scale
    p = tree_leaves(params)
    hps = leaf_hparams(spec, p)

    if spec.name == "adamw":
        b1, b2 = spec.beta1, spec.beta2
        m = [b1 * m_ + (1 - b1) * g_ for m_, g_ in zip(tree_leaves(state["m"]), g)]
        v = [b2 * v_ + (1 - b2) * g_ * g_
             for v_, g_ in zip(tree_leaves(state["v"]), g)]
        sf = step.float()
        bc1 = 1 - b1 ** sf
        bc2 = 1 - b2 ** sf
        new_p = []
        for p_, m_, v_, hp in zip(p, m, v, hps):
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + spec.eps)
            if hp.weight_decay:
                u = u + hp.weight_decay * p_.float()
            new_p.append((p_.float() - (lr * hp.lr_scale) * u).to(p_.dtype))
        return tree_unflatten(params, new_p), {
            "step": step,
            "m": tree_unflatten(params, m),
            "v": tree_unflatten(params, v),
        }

    if spec.name == "sgd":
        m = [spec.momentum * m_ + g_ for m_, g_ in zip(tree_leaves(state["m"]), g)]
        new_p = []
        for p_, m_, hp in zip(p, m, hps):
            u = m_
            if hp.weight_decay:
                u = u + hp.weight_decay * p_.float()
            new_p.append((p_.float() - (lr * hp.lr_scale) * u).to(p_.dtype))
        return tree_unflatten(params, new_p), {
            "step": step, "m": tree_unflatten(params, m),
        }

    raise ValueError(spec.name)


def apply_updates_(
    spec: OptimizerSpec,
    params,
    grads,
    state: Dict[str, Any],
    *,
    grad_scale=1.0,
    lr_scale=1.0,
) -> Tuple[Any, Dict[str, Any]]:
    """:func:`apply_updates` in place, bitwise equal to it: every new
    param and moment is computed by the same expressions, one leaf at a
    time, and copied into the tensor it replaces, so the update holds one
    leaf's temporaries instead of a second copy of the params and
    moments.  Consumes ``grads``: an f32 gradient leaf is scaled and
    clipped in place.  Returns ``params`` and a state holding the same
    moment tensors and the next step."""
    g = [x.float().mul_(grad_scale) for x in tree_leaves(grads)]
    if spec.grad_clip:
        clip = clip_factor(spec, global_norm(g))
        for x in g:
            x.mul_(clip)
    step = state["step"] + 1
    lr = spec.lr * lr_scale
    p = tree_leaves(params)
    hps = leaf_hparams(spec, p)

    if spec.name == "adamw":
        b1, b2 = spec.beta1, spec.beta2
        sf = step.float()
        bc1 = 1 - b1 ** sf
        bc2 = 1 - b2 ** sf
        for p_, m_, v_, g_, hp in zip(p, tree_leaves(state["m"]),
                                      tree_leaves(state["v"]), g, hps):
            m_.copy_(b1 * m_ + (1 - b1) * g_)
            v_.copy_(b2 * v_ + (1 - b2) * g_ * g_)
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + spec.eps)
            if hp.weight_decay:
                u = u + hp.weight_decay * p_.float()
            p_.copy_((p_.float() - (lr * hp.lr_scale) * u).to(p_.dtype))
        return params, {"step": step, "m": state["m"], "v": state["v"]}

    if spec.name == "sgd":
        for p_, m_, g_, hp in zip(p, tree_leaves(state["m"]), g, hps):
            m_.copy_(spec.momentum * m_ + g_)
            u = m_
            if hp.weight_decay:
                u = u + hp.weight_decay * p_.float()
            p_.copy_((p_.float() - (lr * hp.lr_scale) * u).to(p_.dtype))
        return params, {"step": step, "m": state["m"]}

    raise ValueError(spec.name)
