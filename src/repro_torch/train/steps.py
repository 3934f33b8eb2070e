"""Per-leaf train steps of the port: the DDP baseline and DeFT's per-leaf
phases (port of ``repro/train/steps.py``).

The JAX package keeps these as the semantic reference and the benchmark
baseline of the flat engine (``train/runtime.py``):

* ``ddp_train_step``: every gradient leaf all-reduced, the optimizer
  every step.  With ``microbatch = M > 1`` the batch runs as M sequential
  micro-batches whose gradients sum in f32; the loss is divided by M,
  each part averaged over them and the gradients divided by M before the
  one all-reduce a leaf, so the scheduling domain stays one step.
* ``deft_phase_step``: one DeFT phase on tree-shaped state.  ``cur`` and
  ``fut`` are this rank's own per-leaf f32 accumulators.  The phase
  issues one collective per *synced leaf* (a leaf whose bucket its
  ``PhaseSpec`` syncs) on its bucket's link: ``DataParallel.primary``, or
  ``DataParallel.secondary``, hierarchical over pod x data.  It then
  issues one all-reduce per metric (the loss and each part), as JAX's
  ``_deft_body`` issues one ``psum`` each.  The delayed update applies
  the merged generation scaled by ``1 / (n_dp * update_k)``.
* ``make_deft_step_fns``: one callable per distinct ``PhaseSpec`` of a
  schedule, shared by the cycle positions that repeat it.

The steps run eagerly over ``torch.distributed`` process groups in place
of JAX's ``shard_map``.  So ``_anchor_grad_shardings``, ``_state_specs``,
``_batch_specs``, ``_dp_sizes`` and the ``logical_rules`` contexts, which
are sharding plumbing, have no counterpart.  DeFT's updates run
``optim.apply_updates_``, the in-place twin of ``apply_updates`` (bitwise
equal to it), as a donated JAX executable updates its buffers in place;
the DDP baseline keeps the pure ``apply_updates``.  The FSDP variant
``deft_rs_phase_step`` (manual over 'pod', params sharded over 'data' by
logical rules) waits for the port's sharding rules, ROADMAP item 8.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.scheduler import DeftSchedule, PhaseSpec
from repro_torch.models.model import init_params, loss_fn
from repro_torch.optim.optimizers import (
    OptimizerSpec,
    apply_updates,
    apply_updates_,
    init_opt_state,
)
from repro_torch.train.runtime import DataParallel, init_fused_accumulators
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

# a plain dict: params, opt and (DeFT only) this rank's cur/fut
TrainState = Dict[str, Any]


def init_train_state(cfg: ArchConfig, opt_spec: OptimizerSpec, *,
                     deft: bool = False, layout=None,
                     dtype: torch.dtype = torch.float32, seed: int = 0,
                     params=None, device="cuda") -> TrainState:
    """Fresh train state: params drawn at ``dtype`` from ``seed`` (or a
    copy of ``params`` on ``device``, at their own dtype) and f32 moments.
    ``deft=True`` adds the ``cur``/``fut`` generation accumulators: one f32
    buffer per leaf without a ``layout`` (the per-leaf steps), one per
    bucket with one (``init_fused_accumulators``)."""
    if params is None:
        params = init_params(cfg, seed=seed, device=device, dtype=dtype)
    else:
        params = tree_map(lambda p: p.detach().to(device=device, copy=True),
                          params)
    state: TrainState = {"params": params,
                         "opt": init_opt_state(opt_spec, params)}
    if deft and layout is not None:
        state.update(init_fused_accumulators(layout, device))
    elif deft:
        zeros = lambda: tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        state["cur"] = zeros()
        state["fut"] = zeros()
    return state


def _loss_and_grads(params, cfg, batch, **kw):
    """Loss, parts and every leaf's gradient at ``params`` (contiguous, as
    the collectives take them); a leaf the loss never reads (an enc-dec
    block's ungated gate) gets zeros, as ``jax.grad`` gives it."""
    params = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(params)
    loss, parts = loss_fn(params, cfg, batch, **kw)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, \
        [g.contiguous() for g in grads]


# ---------------------------------------------------------------------------
# Baseline: DDP (every leaf syncs, update every step)
# ---------------------------------------------------------------------------
def ddp_train_step(state: TrainState, batch, *, cfg: ArchConfig,
                   opt_spec: OptimizerSpec, dp: DataParallel,
                   loss_chunk: int = 0, attn_impl: Optional[str] = None,
                   scan_impl: Optional[str] = None, microbatch: int = 0
                   ) -> Tuple[TrainState, Dict[str, Any]]:
    """The DDP baseline step: one all-reduce per gradient leaf, the
    per-leaf optimizer every step, the loss and parts on one stacked
    all-reduce.  ``microbatch = M > 1`` cuts this rank's batch into M
    sequential micro-batches (activation memory M-fold smaller for one f32
    gradient tree): their gradients sum in f32 from zero, then the loss is
    divided by M, each part averaged and the gradients divided by M, as
    JAX's scan over the micro-batches does."""
    kw = dict(loss_chunk=loss_chunk, attn_impl=attn_impl, scan_impl=scan_impl)
    if microbatch and microbatch > 1:
        m = microbatch
        n = next(iter(batch.values())).shape[0]
        if n % m:
            raise ValueError(f"a batch of {n} does not split into {m} "
                             f"micro-batches")
        per = n // m
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in tree_leaves(state["params"])]
        lsum = torch.zeros((), dtype=torch.float32, device=gsum[0].device)
        micro_parts: List[Dict[str, torch.Tensor]] = []
        for j in range(m):
            mb = {k: v[j * per:(j + 1) * per] for k, v in batch.items()}
            loss_j, parts_j, grads = _loss_and_grads(state["params"], cfg, mb,
                                                     **kw)
            for a, g in zip(gsum, grads):
                a.add_(g.float())
            del grads
            lsum = lsum + loss_j
            micro_parts.append(parts_j)
        loss = lsum / m
        parts = {k: torch.stack([p[k] for p in micro_parts]).mean()
                 for k in micro_parts[0]}
        grads = [g.div_(m) for g in gsum]
    else:
        loss, parts, grads = _loss_and_grads(state["params"], cfg, batch, **kw)
    for g in grads:
        dp.primary(g)
    params = state["params"]
    new_params, opt = apply_updates(opt_spec, params,
                                    tree_unflatten(params, grads),
                                    state["opt"], grad_scale=1.0 / dp.n_dp)
    keys = sorted(parts)
    stacked = dp.metrics(torch.stack([loss] + [parts[k] for k in keys])) \
        / dp.n_dp
    metrics = {"loss": stacked[0],
               **{k: stacked[1 + j] for j, k in enumerate(keys)},
               "updated": True}
    return {"params": new_params, "opt": opt}, metrics


# ---------------------------------------------------------------------------
# DeFT phase step on per-leaf state
# ---------------------------------------------------------------------------
def phase_collectives_per_leaf(phase: PhaseSpec, bucket_of_leaf: Sequence[int],
                               n_parts: int, *,
                               leaf_sizes: Optional[Sequence[int]] = None,
                               n_data: int = 1) -> Dict[str, int]:
    """Collectives one per-leaf phase issues, by construction: a primary or
    secondary sync per leaf and scheduled generation of its bucket (the
    fresh one when it rotates onto the wire, the older one when the phase
    syncs ``cur``), plus one all-reduce per metric: the loss and each of
    the ``n_parts`` parts.  With ``leaf_sizes`` (a 'pod' group over
    ``n_data`` 'data' ranks), a secondary sync of a leaf that splits over
    the 'data' ranks adds one all-reduce over 'pod' (``outer``)."""
    out = {"primary": 0, "secondary": 0, "metrics": 1 + n_parts}
    if leaf_sizes is not None:
        out["outer"] = 0
    for i, b in enumerate(bucket_of_leaf):
        n = int(phase.rotate and phase.route_new[b] == "sync") \
            + int(phase.sync_cur[b])
        out["secondary" if phase.secondary[b] else "primary"] += n
        if leaf_sizes is not None and phase.secondary[b] \
                and leaf_sizes[i] % n_data == 0 and leaf_sizes[i] >= n_data:
            out["outer"] += n
    return out


def _deft_body(state: TrainState, batch, *, cfg: ArchConfig,
               opt_spec: OptimizerSpec, phase: PhaseSpec,
               bucket_of_leaf: Sequence[int], dp: DataParallel,
               loss_chunk: int = 0, attn_impl: Optional[str] = None,
               scan_impl: Optional[str] = None
               ) -> Tuple[TrainState, Dict[str, Any]]:
    """One DeFT phase on per-leaf state (JAX's ``_deft_body``).  The
    accumulators are updated in place and the generation that dies is
    dropped; a forced-liveness phase that updates without rotating leaves
    ``cur`` zero until the next rotation fills it."""
    n_dp = dp.n_dp
    loss, parts, grads = _loss_and_grads(
        state["params"], cfg, batch, loss_chunk=loss_chunk,
        attn_impl=attn_impl, scan_impl=scan_impl)
    cur = tree_leaves(state["cur"])
    fut = tree_leaves(state["fut"])
    if len(grads) != len(bucket_of_leaf):
        raise ValueError(f"bucket_of_leaf maps {len(bucket_of_leaf)} leaves; "
                         f"the model has {len(grads)}")

    def sync(x: torch.Tensor, b: int) -> torch.Tensor:
        (dp.secondary if phase.secondary[b] else dp.primary)(x.view(-1))
        return x

    if phase.rotate:
        # the fresh generation merges with the future accumulator
        gen = [g.float().add_(f) for g, f in zip(grads, fut)]
        gen = [sync(x, bucket_of_leaf[i])
               if phase.route_new[bucket_of_leaf[i]] == "sync" else x
               for i, x in enumerate(gen)]
        new_fut = [f.zero_() for f in fut]
    else:
        gen = None
        new_fut = [f.add_(g) for f, g in zip(fut, grads)]
    del grads
    cur_synced = [sync(c, bucket_of_leaf[i])
                  if phase.sync_cur[bucket_of_leaf[i]] else c
                  for i, c in enumerate(cur)]

    params, opt = state["params"], state["opt"]
    if phase.do_update:
        src = cur_synced if phase.update_source == "cur" else gen
        # in place: the consumed generation is scaled where it lies
        params, opt = apply_updates_(
            opt_spec, params, tree_unflatten(params, src), opt,
            grad_scale=1.0 / (n_dp * phase.update_k))
        if phase.update_source == "cur" and gen is not None:
            new_cur = gen
        else:
            new_cur = [c.zero_() for c in cur_synced]
    elif phase.rotate:
        new_cur = gen
    else:
        new_cur = cur_synced

    def mean(x: torch.Tensor) -> torch.Tensor:
        return dp.metrics(x.reshape(1).clone())[0] / n_dp

    metrics = {"loss": mean(loss),
               **{k: mean(parts[k]) for k in sorted(parts)},
               "updated": phase.do_update, "k": phase.update_k}
    return {"params": params, "opt": opt,
            "cur": tree_unflatten(state["cur"], new_cur),
            "fut": tree_unflatten(state["fut"], new_fut)}, metrics


def deft_phase_step(state: TrainState, batch, *, cfg: ArchConfig,
                    opt_spec: OptimizerSpec, phase: PhaseSpec,
                    bucket_of_leaf: Sequence[int], group=None,
                    outer_group=None, loss_chunk: int = 0,
                    attn_impl: Optional[str] = None,
                    scan_impl: Optional[str] = None
                    ) -> Tuple[TrainState, Dict[str, Any]]:
    """DeFT phase with params replicated over the DP ranks: over the 'data'
    group ``group`` (None: the world), or the joint pod x data sum with
    ``outer_group`` the 'pod' group (``launch.train.pod_groups``)."""
    return _deft_body(state, batch, cfg=cfg, opt_spec=opt_spec, phase=phase,
                      bucket_of_leaf=bucket_of_leaf,
                      dp=DataParallel(group, outer=outer_group),
                      loss_chunk=loss_chunk, attn_impl=attn_impl,
                      scan_impl=scan_impl)


def deft_rs_phase_step(*args, **kwargs):
    """JAX's DeFT path for the FSDP archs (manual over 'pod', params and
    moments FSDP-sharded over 'data' by ``rules_deft_rs_manual_pod``):
    not ported.  It needs the port's logical sharding rules, ROADMAP item
    8; the sharded flat engine (``DeftRuntime(fsdp=True)``) is the port's
    FSDP engine."""
    raise NotImplementedError(
        "deft_rs_phase_step (DeFT over 'pod' with params FSDP-sharded over "
        "'data' by logical sharding rules) needs the port's sharding rules, "
        "ROADMAP item 8: use the sharded flat engine, "
        "DeftRuntime(fsdp=True)")


class PhaseStep:
    """The step callable of one distinct phase, ``(state, batch) ->
    (state, metrics)``; ``last_collectives`` counts what its last call
    issued (``phase_collectives_per_leaf``)."""

    def __init__(self, phase: PhaseSpec, dp: DataParallel, **kw):
        self.phase = phase
        self.dp = dp
        self.kw = kw
        self.last_collectives: Dict[str, int] = {}

    def __call__(self, state: TrainState, batch
                 ) -> Tuple[TrainState, Dict[str, Any]]:
        self.dp.reset()
        out = _deft_body(state, batch, phase=self.phase, dp=self.dp,
                         **self.kw)
        self.last_collectives = dict(self.dp.counts)
        return out


def make_deft_step_fns(cfg: ArchConfig, opt_spec: OptimizerSpec,
                       schedule: DeftSchedule, bucket_of_leaf: Sequence[int],
                       *, group=None, outer_group=None, fsdp: bool = False,
                       loss_chunk: int = 0, attn_impl: Optional[str] = None,
                       scan_impl: Optional[str] = None) -> List[PhaseStep]:
    """The per-leaf path: one step callable per cycle position, the
    positions of one ``PhaseSpec`` sharing one callable; one collective a
    synced leaf, tree-shaped accumulators.  Kept as the semantic reference
    and the benchmark baseline of ``DeftRuntime``.  ``fsdp=True`` (JAX's
    ``deft_rs_phase_step``) is refused, ROADMAP item 8."""
    if fsdp:
        deft_rs_phase_step()
    dp = DataParallel(group, outer=outer_group)
    kw = dict(cfg=cfg, opt_spec=opt_spec, bucket_of_leaf=tuple(bucket_of_leaf),
              loss_chunk=loss_chunk, attn_impl=attn_impl, scan_impl=scan_impl)
    seen: Dict[PhaseSpec, PhaseStep] = {}
    fns: List[PhaseStep] = []
    for phase in schedule.phases:
        if phase not in seen:
            seen[phase] = PhaseStep(phase, dp, **kw)
        fns.append(seen[phase])
    return fns
