"""DeftRuntime of the port: the replicated flat-resident DeFT engine.

Port of ``repro/train/runtime.py`` (``_route_and_sync``,
``_deft_body_flat``, ``DeftRuntime``, ``phase_collectives``,
``make_ddp_step``) for replicated data parallelism over a
``torch.distributed`` process group, executed eagerly:

* params, AdamW moments and the ``cur``/``fut`` gradient generations are
  per-bucket flat f32 buffers (``BucketLayout``); the forward reads params
  through views of the param buffers, and autograd accumulates every
  leaf's gradient straight into a view of a flat gradient buffer, so the
  gradients of a bucket arrive already packed;
* each phase issues exactly the collectives its ``PhaseSpec`` schedules:
  one ``all_reduce`` per primary-synced bucket, one reduce-scatter +
  all-gather pair per secondary-synced bucket (``all_reduce`` when the
  buffer does not tile over the ranks, as JAX falls back to ``psum``),
  and one ``all_reduce`` of the stacked metrics;
* update phases run one fused bucket-update kernel per bucket, with the
  accumulator zeroing fused into the same launch where JAX fuses it;
* precision (DESIGN.md §13): every bucket sync runs at the bucket's wire
  dtype from ``layout.precision`` (``_wire_sync``: an int8 wire projects
  the buffer onto the blockwise int8 grid in place before an f32 sum, a
  bf16 wire sums a bf16 copy and promotes it back); a ``bf16sr`` master
  keeps the param buffers in bf16, rounded after every update by the
  seeded stochastic-rounding kernel; ``compute_dtype`` casts the param
  buffers once per step for the forward.  Gradients are taken with
  respect to the cast params, as JAX differentiates after
  ``_cast_compute``: a low-precision gradient lands in a per-bucket
  scratch buffer of its dtype and is promoted exactly into the f32
  gradient buffer.

With ``fsdp=True`` it is the sharded flat engine instead (port of
``_deft_body_flat_rs``, DESIGN.md §8-§9): each rank keeps only its
contiguous 1/N span of every param and moment buffer
(``layout.shard_sizes``); the forward all-gathers the spans into full
buffers at each bucket's wire precision (``_wire_gather``: int8 gathers
the int8 values and the per-row f32 scales), or reuses the previous
phase's gathered buffers where no update came in between (the gather
skip, ``pgather``); a scheduled sync is a reduce-scatter into this rank's
span, followed by an all-gather back into the full buffer only when the
generation outlives the phase; the update kernels run on the spans,
clipped by the norm summed across ranks.  ``cur``/``fut`` stay full
length on every rank: an unsynced generation holds contributions to
every span.  With ``decoupled`` (DESIGN.md §12) the param gathers are not
a burst before the forward: each is issued ahead of the forward's first
touch of its bucket (``train/streaming.py``).

Over a ``pod x data`` layout (an outer group, DESIGN.md §8) the joint
syncs run over the world and the others are hierarchical: reduce-scatter
over 'data', all-reduce over 'pod', all-gather over 'data'; the sharded
engine's spans are 1/N over 'data'.  With ``secondary_chain`` (DESIGN.md
§14) the secondary link's collectives, and the param gathers an AG plan
puts on it, run along that ring chain of the 'data' ranks
(``train/chains.py``), bitwise the JAX chain's.

JAX's arrays are immutable and its executables donate the state; the
port updates the buffers in place instead (the same memory footprint:
param, two moments, two generations and one gradient buffer per bucket,
plus the gathered params on the sharded engine) and recycles the
consumed generation as the next step's gradient buffer.
There is no AOT cache: phases are deduplicated by ``PhaseSpec`` and each
unique phase keeps its dispatch statistics.

The runtime's control surface (DESIGN.md §9-§11) is the JAX runtime's:
``prepare_swap`` stages a replanned schedule, optionally under another
bucket layout, and ``step`` installs it at the next cycle boundary,
re-packing the resident buffers in place when the layout changes
(``repack_state``); ``spawn`` builds a sibling runtime; every control-plane
event, and with a ``tracer`` every step's phase and collective spans, is
recorded into an ``obs.Tracer``.  A staged build derives the new segments,
masks and phase table and loads the kernel libraries the staged layout
runs, so no compiler runs on the hot path after the swap.

With ``flat_state=False`` it is the tree-state engine instead (port of
``_deft_body_fused``, which the JAX package keeps as a benchmark
baseline): params and moments stay trees; the gradients are flattened
into fresh per-bucket f32 buffers (``flatten_buckets``), routed and
synced bucket by bucket as on the flat engine (``_route_and_sync``), and
an update applies the merged generation through its leaf views with
``optim.apply_updates_`` (the in-place twin of ``apply_updates``, bitwise
equal to it, as JAX's donated executable updates in place) instead of
the bucket-update kernel.  It runs f32 wires at the params' own
resident dtype (no ``compute_dtype``, no bf16sr master), as JAX's
``RuntimeConfig.validate`` requires; a tree state over sharded params
(JAX's ``deft_rs_phase_step_fused``) is not ported, ROADMAP item 8.3.

Over a mesh (``launch.mesh.Mesh``, ``mesh=``) the syncs run over its
'data' and 'pod' groups and the joint sums over its ('pod', 'data')
group; with a 'model' axis above 1 each rank holds its shards of the
leaves ``sharding.tp.model_specs`` splits (JAX's ``spec_tree`` under
``rules_deft_manual_dp``), its bucket layout is built over those shards
with the planner's global bucket assignment (every model rank's the
same, as the split leaves' shards are equal), the forward runs
tensor-parallel (``sharding/tp.py``), and the clip norm is
``sharding.tp.SpanNorm`` over the buffers or spans.  The sharded engine's
spans are 1/N of this rank's buckets over its 'data' line (the mesh's
'data' group holds the model coordinate fixed, so its reduce-scatters
and param gathers never cross model ranks).  Both flat engines run there
in f32, on every config; the tree-state engine, the precision path, AG
streaming, chains and the control surface refuse a model axis (ROADMAP
item 8.2).

A checkpoint holds JAX's tree form of the state (``state_to_tree``):
layout-free param and moment trees, the ``cur``/``fut`` accumulators as
``(accum_devices, n)`` stacks of every DP rank's buffer, and the gather
cache; ``tree_to_state`` inverts it, through a ``LayoutTransition`` when
the checkpoint's layout differs, and ``reset_cycle`` resumes the schedule
at the saved cycle position.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.core.precision import WIRE_BYTES
from repro_torch.core.scheduler import DeftSchedule, PhaseSpec
from repro_torch.kernels.bucket_update import (
    apply_bucket_updates,
    build_segments,
    init_flat_opt_state,
)
from repro_torch.kernels.quantize import (
    cast_compute,
    dequantize_int8,
    quantize_dequantize_int8,
    quantize_int8,
    stochastic_round_bf16,
)
from repro_torch.models.model import init_params, loss_fn
from repro_torch.obs.trace import Tracer
from repro_torch.optim.optimizers import (
    OptimizerSpec,
    apply_updates_,
    init_opt_state,
)
from repro_torch.sharding.tp import (
    PATHS_ITEM,
    ModelParallel,
    SpanNorm,
    gather_params,
    global_norm,
    model_specs,
    shard_params,
    split_leaves,
)
from repro_torch.train.bucketing import (
    BucketLayout,
    LayoutTransition,
    build_layout_transition,
    flatten_bucket,
    flatten_buckets,
    repack_buffers,
    unflatten_buckets,
)
from repro_torch.train.chains import (
    chain_all_gather,
    chain_all_reduce,
    chain_reduce_scatter,
)
from repro_torch.train.streaming import ParamStream, lazy_param_tree
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

TrainState = Dict[str, Any]
_UNSET: Any = object()      # "keep this runtime's value" (spawn)


class DataParallel:
    """The collectives of the DeFT engines, with a count of what was
    issued (reset per step by the runtime).  ``keys`` names the counts:
    ``REPLICATED`` for the replicated engine and the DDP baseline,
    ``SHARDED`` for the sharded flat engine.

    ``group`` is the 'data' group (None: the world).  ``outer`` is the
    'pod' group of a ``pod x data`` layout of the world
    (``launch.train.pod_groups``; None: one DP axis): the joint
    ``('pod', 'data')`` sums (primary syncs, metrics) then run over the
    world, and every sharded sync adds an all-reduce over ``outer``
    (counted as ``outer``).  ``chain`` is the secondary link's ring chain
    over the 'data' group's ranks: secondary syncs, and the gathers the
    engine marks ``chained``, run along it (``train/chains.py``), each
    counted as ``chained`` besides its own count, each of its rounds as
    ``chain_rounds``, with the round's ``(source, destination)`` pairs
    appended to ``p2p``.  ``joint`` is the group of the joint sums where
    it is not the world (a mesh with a 'model' axis: the ('pod', 'data')
    group of this rank's model position, ``Mesh.dp_group``)."""

    REPLICATED = ("primary", "secondary", "metrics")
    SHARDED = ("param_gather", "reduce_scatter", "all_gather", "norm",
               "metrics")

    def __init__(self, group=None, keys: Tuple[str, ...] = REPLICATED, *,
                 outer=None, chain: Optional[Tuple[int, ...]] = None,
                 joint: Any = _UNSET):
        if not dist.is_initialized():
            raise RuntimeError(
                "the DeFT runtime syncs through torch.distributed: initialise "
                "a process group first (launch.train.init_distributed)"
            )
        self.group = group
        self.outer = outer
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.n_outer = 1 if outer is None else dist.get_world_size(outer)
        self.n_dp = self.size * self.n_outer
        # the group of a joint sum over every DP axis
        if joint is _UNSET:
            joint = group if outer is None else None
        self.joint = joint
        if outer is not None and self.n_dp != dist.get_world_size(joint):
            raise ValueError(
                f"a {self.n_outer} x {self.size} pod x data layout does not "
                f"cover the {dist.get_world_size(joint)} ranks of its joint "
                f"group")
        self.chain = chain
        keys = tuple(keys) + (("outer",) if outer is not None else ()) \
            + (("chained", "chain_rounds") if chain is not None else ())
        self.counts = dict.fromkeys(keys, 0)
        self.p2p: List[Tuple[Tuple[int, int], ...]] = []

    def reset(self) -> None:
        self.counts = dict.fromkeys(self.counts, 0)
        self.p2p = []

    def _round(self, perm: Tuple[Tuple[int, int], ...]) -> None:
        self.p2p.append(perm)
        self.counts["chain_rounds"] += 1

    def _outer_sum(self, x: torch.Tensor) -> torch.Tensor:
        if self.outer is not None:
            dist.all_reduce(x, group=self.outer)
            self.counts["outer"] += 1
        return x

    def primary(self, x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, group=self.joint)
        self.counts["primary"] += 1
        return x

    def secondary(self, x: torch.Tensor) -> torch.Tensor:
        """In place: along the chain with one DP axis; else reduce-scatter
        over 'data', all-reduce over 'pod', all-gather over 'data';
        ``all_reduce`` when the buffer does not split evenly over 'data'."""
        n = x.numel()
        if self.chain is not None and self.outer is None:
            chain_all_reduce(x, self.chain, self.group, self._round)
            self.counts["chained"] += 1
        elif n % self.size == 0 and n >= self.size:
            shard = torch.empty(n // self.size, dtype=x.dtype, device=x.device)
            dist.reduce_scatter_tensor(shard, x, group=self.group)
            self._outer_sum(shard)
            dist.all_gather_into_tensor(x, shard, group=self.group)
        else:
            dist.all_reduce(x, group=self.joint)
        self.counts["secondary"] += 1
        return x

    def reduce_scatter(self, x: torch.Tensor, chained: bool = False
                       ) -> torch.Tensor:
        """This rank's 'data' span of every rank's sum of ``x`` (a new
        tensor at more than one rank): a reduce-scatter over 'data' (along
        the chain when ``chained``), then an all-reduce over 'pod'."""
        if chained:
            out = chain_reduce_scatter(x, self.chain, self.group, self._round)
            self.counts["chained"] += 1
        else:
            out = torch.empty(x.numel() // self.size, dtype=x.dtype,
                              device=x.device)
            dist.reduce_scatter_tensor(out, x, group=self.group)
        self.counts["reduce_scatter"] += 1
        return self._outer_sum(out)

    def all_gather(self, span: torch.Tensor,
                   out: Optional[torch.Tensor] = None,
                   count: str = "all_gather", chained: bool = False,
                   async_op: bool = False):
        """Every 'data' rank's ``span`` concatenated in rank order, into
        ``out`` (a new tensor when None), along the chain when ``chained``;
        counted under ``count``.  ``async_op`` returns (out, work): the
        buffer is valid after ``work.wait()``."""
        if out is None:
            out = torch.empty(span.numel() * self.size, dtype=span.dtype,
                              device=span.device)
        work = None
        if chained:
            chain_all_gather(span, self.chain, self.group, out, self._round)
            self.counts["chained"] += 1
        else:
            work = dist.all_gather_into_tensor(out, span, group=self.group,
                                               async_op=async_op)
        self.counts[count] += 1
        return (out, work) if async_op else out

    def norm(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the 'data' ranks of squared-norm scalars (in
        place, one collective): the pod replicas hold the same spans."""
        dist.all_reduce(x.reshape(-1), group=self.group)
        self.counts["norm"] += 1
        return x

    def metrics(self, x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, group=self.joint)
        self.counts["metrics"] += 1
        return x


def init_fused_accumulators(layout: BucketLayout, device="cuda"
                            ) -> Dict[str, Tuple[torch.Tensor, ...]]:
    """Per-bucket flat f32 ``cur``/``fut`` generation buffers."""
    zeros = lambda: tuple(torch.zeros((s,), dtype=torch.float32, device=device)
                          for s in layout.buf_sizes)
    return {"cur": zeros(), "fut": zeros()}


def _route_and_sync(phase: PhaseSpec, g_flat, cur, fut, sync):
    """DeFT generation bookkeeping on per-bucket flat buffers (in place).

    Returns (gen, new_fut, cur_synced): the merged fresh generation (or
    None when not rotating; it lives in the gradient buffers), the next
    future accumulator, and the older generation with this phase's
    scheduled collectives applied."""
    if phase.rotate:
        # fresh generation merges with the future accumulator (Cases 3/4)
        gen = [g.add_(f) for g, f in zip(g_flat, fut)]
        gen = [sync(x, b) if phase.route_new[b] == "sync" else x
               for b, x in enumerate(gen)]
        new_fut = [f.zero_() for f in fut]
    else:
        # Cases 1/2: fresh gradients accumulate locally
        gen = None
        new_fut = [f.add_(g) for f, g in zip(fut, g_flat)]
    cur_synced = [sync(c, b) if phase.sync_cur[b] else c
                  for b, c in enumerate(cur)]
    return gen, new_fut, cur_synced


def _cur_at_boundary(schedule: DeftSchedule) -> List[str]:
    """Each bucket's ``cur`` as a cycle of ``schedule`` leaves it at its
    boundary (the steady state: two cycles from zero accumulators):
    'zero', 'local' (this rank's own gradients) or 'summed' (over every
    DP rank), by ``_route_and_sync`` and the update's rules."""
    nb = len(schedule.phases[0].route_new)
    cur = ["zero"] * nb
    for ph in schedule.phases * 2:
        gen = (["summed" if r == "sync" else "local" for r in ph.route_new]
               if ph.rotate else None)
        cur = ["summed" if ph.sync_cur[b] and s == "local" else s
               for b, s in enumerate(cur)]
        if ph.do_update:
            cur = (gen if gen is not None and ph.update_source == "cur"
                   else ["zero"] * nb)
        elif gen is not None:
            cur = gen
    return cur


def _cur_reading(schedule: DeftSchedule) -> List[Optional[str]]:
    """How the first cycle of ``schedule`` reads each bucket's ``cur`` as
    it stands at position 0: 'local' where it sums it before applying it,
    'summed' where it applies it as it is, None where a rotation or an
    update of the fresh generation drops it unread."""
    nb = len(schedule.phases[0].route_new)
    out: List[Optional[str]] = [None] * nb
    open_ = [True] * nb
    for ph in schedule.phases:
        for b in range(nb):
            if not open_[b]:
                continue
            if ph.sync_cur[b]:
                out[b] = "local"
            elif ph.do_update and ph.update_source == "cur":
                out[b] = "summed"
            elif not (ph.rotate or ph.do_update):
                continue
            open_[b] = False
    return out


def _generation_steps(schedule: DeftSchedule, start: Tuple[int, int] = (0, 0),
                      cycles: int = 1
                      ) -> Tuple[Tuple[int, int], List[Optional[int]]]:
    """Walk ``cycles`` cycles of ``schedule`` from ``start`` = (the steps
    whose gradients ``cur`` holds, those ``fut`` holds), by
    ``_route_and_sync``'s and the update's rules.  Returns the counts the
    walk ends at and, for each step, how many steps' gradients its update
    applies (None where it applies none)."""
    cur, fut = start
    applied: List[Optional[int]] = []
    for ph in schedule.phases * cycles:
        gen = None
        if ph.rotate:
            gen, fut = fut + 1, 0
        else:
            fut += 1
        if ph.do_update:
            applied.append(cur if ph.update_source == "cur" else gen)
            cur = gen if gen is not None and ph.update_source == "cur" else 0
        else:
            applied.append(None)
            if gen is not None:
                cur = gen
    return (cur, fut), applied


def _steady_counts(schedule: DeftSchedule) -> Tuple[int, int]:
    """(``cur``, ``fut``) step counts at a cycle boundary of ``schedule``'s
    steady state, walked from zero accumulators."""
    seen, at = [], (0, 0)
    while at not in seen:
        seen.append(at)
        at = _generation_steps(schedule, at)[0]
    return at


def handover_divisors(src: DeftSchedule, dst: DeftSchedule
                      ) -> List[Optional[int]]:
    """After a swap from ``src`` to ``dst`` at a cycle boundary: for each
    step from the boundary until ``dst``'s accumulators hold what its own
    cycle leaves them, the number of steps in the generation that step's
    update applies where it is not the phase's ``update_k`` (and not an
    empty generation), else None.  ``update_k`` counts the steps ``dst``'s
    steady state merges; the generations ``src`` handed over may hold
    another number (a one-step generation meeting an update of k 2), and
    the update divides by what it applies, so that it applies their
    mean."""
    at, want = _steady_counts(src), _steady_counts(dst)
    out: List[Optional[int]] = []
    for _ in range(4):         # dst's own warm-up from zero takes fewer
        if at == want:
            break
        at, applied = _generation_steps(dst, at)
        out += [n if n and n != ph.update_k else None
                for ph, n in zip(dst.phases, applied)]
    return out


def _fused_metrics(loss, parts, phase: PhaseSpec, n_dp: int,
                   dp: DataParallel) -> Dict[str, Any]:
    """Loss and aux parts ride ONE all-reduce, stacked to a vector."""
    keys = sorted(parts)
    stacked = torch.stack([loss.detach()] + [parts[k].detach() for k in keys])
    stacked = dp.metrics(stacked) / n_dp
    return {
        "loss": stacked[0],
        **{k: stacked[1 + j] for j, k in enumerate(keys)},
        "updated": phase.do_update,
        "k": phase.update_k,
    }


def phase_collectives(phase: PhaseSpec, layout: Optional[BucketLayout] = None,
                      *, n_data: int = 1, outer: bool = False,
                      chain: bool = False) -> Dict[str, int]:
    """Collectives one phase issues, by construction: a primary or
    secondary sync per scheduled generation of a bucket (the fresh one
    when it rotates onto the wire, the older one when the phase syncs
    ``cur``: a bucket with both takes two, where JAX's census counts one,
    ROADMAP section 3), plus the single metrics all-reduce.  Over
    ``n_data`` 'data' ranks with an ``outer`` 'pod' group, a secondary
    sync whose buffer (``layout``) splits over the ranks adds one
    all-reduce over 'pod'; with a ``chain`` each secondary sync is
    chained, in ``2 (n_data - 1)`` rounds."""
    syncs = _syncs_of_phase(phase)
    primary = sum(k for b, k in enumerate(syncs) if not phase.secondary[b])
    secondary = [(b, k) for b, k in enumerate(syncs) if phase.secondary[b]]
    n_secondary = sum(k for _, k in secondary)
    out = {"primary": primary, "secondary": n_secondary, "metrics": 1}
    if outer:
        out["outer"] = sum(k for b, k in secondary
                           if layout.buf_sizes[b] % n_data == 0
                           and layout.buf_sizes[b] >= n_data)
    if chain:
        out["chained"] = n_secondary
        out["chain_rounds"] = 2 * (n_data - 1) * n_secondary
    return out


def _syncs_of_phase(phase: PhaseSpec) -> List[int]:
    """Per bucket, the generations ``_route_and_sync`` puts on the wire in
    ``phase``: the fresh one when it rotates onto it, plus ``cur`` when
    the phase syncs it (0, 1 or 2)."""
    return [int(phase.rotate and phase.route_new[b] == "sync")
            + int(phase.sync_cur[b]) for b in range(len(phase.route_new))]


def phase_collectives_sharded(phase: PhaseSpec, layout: BucketLayout,
                              reuse: Optional[Tuple[bool, ...]],
                              clip: bool, *, outer: bool = False,
                              chain: bool = False,
                              ag_links: Optional[Tuple[bool, ...]] = None
                              ) -> Dict[str, int]:
    """Collectives one phase of the sharded flat engine issues, by
    construction: a param all-gather per bucket whose gather is not reused
    (two on an int8 wire: values and scales), a reduce-scatter per synced
    generation of a bucket, a trailing all-gather per synced generation
    that outlives the phase, one norm all-reduce per update with grad
    clipping on, and the single metrics all-reduce.  With an ``outer``
    'pod' group every reduce-scatter adds one all-reduce over it; with a
    ``chain`` over the ``layout.shards`` 'data' ranks, each reduce-scatter
    and trailing all-gather of a secondary bucket, and each param gather
    ``ag_links`` marks, is chained, in ``shards - 1`` rounds."""
    n = len(phase.route_new)
    reuse = reuse or (False,) * n
    links = ag_links or (False,) * n
    consumed_new = phase.do_update and phase.update_source == "new"
    consumed_cur = phase.do_update and phase.update_source == "cur"
    new = [phase.rotate and phase.route_new[b] == "sync" for b in range(n)]
    cur = list(phase.sync_cur)
    gathers = [0 if reuse[b] else 2 if layout.wire(b) == "int8" else 1
               for b in range(n)]
    # per bucket: reduce-scatters, trailing all-gathers
    rs = [int(new[b]) + int(cur[b]) for b in range(n)]
    ag = [(0 if consumed_new else int(new[b]))
          + (0 if consumed_cur else int(cur[b])) for b in range(n)]
    out = {
        "param_gather": sum(gathers),
        "reduce_scatter": sum(rs),
        "all_gather": sum(ag),
        "norm": int(bool(phase.do_update and clip)),
        "metrics": 1,
    }
    if outer:
        out["outer"] = sum(rs)
    if chain:
        out["chained"] = sum((rs[b] + ag[b] if phase.secondary[b] else 0)
                             + (gathers[b] if links[b] else 0)
                             for b in range(n))
        out["chain_rounds"] = (layout.shards - 1) * out["chained"]
    return out


def _gather_reuse_masks(schedule: DeftSchedule) -> List[Tuple[bool, ...]]:
    """Per cycle position, the per-bucket gather-skip mask.  A stored
    gather is valid when no update touched the params since the previous
    phase gathered them, i.e. when that phase did not update; position 0
    always gathers, so a fresh cycle never reads a cold cache."""
    return [((t > 0 and not schedule.phases[t - 1].do_update),)
            * len(ph.route_new) for t, ph in enumerate(schedule.phases)]


def wire_bytes(wire: str, n: int) -> int:
    """Bytes one sync of an ``n``-element buffer puts on the wire at
    ``wire`` precision: int8 counts the values plus 4 bytes of scale per
    128-lane row."""
    return n + 4 * (n // 128) if wire == "int8" else n * WIRE_BYTES[wire]


def wire_bytes_split_of_phase(phase: PhaseSpec, layout: BucketLayout
                              ) -> Tuple[int, int]:
    """Planned (primary, secondary) wire bytes of one phase's scheduled
    gradient syncs under ``layout``'s precision policy, split by
    ``phase.secondary`` (JAX's ``_wire_bytes_split_of_phase``, with a
    bucket that syncs two generations counted twice, as
    ``phase_collectives`` counts it)."""
    split = [0, 0]
    for b, k in enumerate(_syncs_of_phase(phase)):
        split[bool(phase.secondary[b])] += k * wire_bytes(
            layout.wire(b), layout.buf_sizes[b])
    return split[0], split[1]


@dataclasses.dataclass
class _PendingSwap:
    """A fully built staged schedule, installed by ``step`` at the next
    cycle boundary; ``layout`` is None when the layout stays."""

    schedule: DeftSchedule
    keys: List[Tuple]                  # DeftRuntime._schedule_keys
    layout: Optional[BucketLayout] = None
    segments: Any = None
    transition: Optional[LayoutTransition] = None


def _wire_sync(x: torch.Tensor, wire: str, collective,
               impl: Optional[str] = None) -> torch.Tensor:
    """Run a gradient-sum ``collective`` at a bucket's wire precision, the
    result landing in ``x`` (the buffer identity the generation
    bookkeeping relies on).

    * ``bf16`` sums a bf16 copy (half the wire bytes) and promotes the
      result back into the f32 buffer.
    * ``int8`` projects the local contribution onto the blockwise int8
      grid in place and sums in f32: an int8 ring sum would overflow at
      the first hop, so this is the JAX package's value-exact emulation of
      the quantized wire (DESIGN.md §13).
    """
    if wire == "bf16":
        return x.copy_(collective(x.to(torch.bfloat16)))
    if wire == "int8":
        quantize_dequantize_int8(x, impl=impl, out=x)
    return collective(x)


def _wire_reduce_scatter(x: torch.Tensor, wire: str, reduce_scatter,
                         impl: Optional[str] = None) -> torch.Tensor:
    """The shard-local half of a sharded sync at a bucket's wire
    precision: this rank's span of the ranks' sum of ``x``, as a new f32
    tensor.  An int8 wire projects ``x`` onto the grid in place first, as
    ``_wire_sync`` does; the engine reads ``x`` after that only as the
    target of the trailing all-gather, or not at all when the update
    consumes the bucket."""
    if wire == "bf16":
        return reduce_scatter(x.to(torch.bfloat16)).float()
    if wire == "int8":
        quantize_dequantize_int8(x, impl=impl, out=x)
    return reduce_scatter(x)


def _wire_gather_start(span: torch.Tensor, wire: str, start,
                       out: torch.Tensor, impl: Optional[str] = None
                       ) -> Callable[[], torch.Tensor]:
    """Issue one param all-gather at a bucket's wire precision and return
    the function that waits for it and decodes it into ``out``, a full
    buffer of the forward's dtype (so the wire dtype is invisible
    downstream).  ``start(x, out=None)`` issues the all-gather of ``x``
    and returns (its result buffer, a work to wait on or None).

    * ``int8`` quantizes the f32 span and issues the gathers of the int8
      values and the per-row f32 scales; the finish dequantizes the whole
      buffer.
    * ``bf16`` gathers a bf16 copy of the span and casts it to ``out``.
    * ``f32`` casts the span to the forward dtype before the gather (the
      cast is elementwise, so the gathered values are the same and a bf16
      forward moves half the bytes)."""
    if wire == "int8":
        q, s = quantize_int8(span.float(), impl=impl)
        (qg, wq), (sg, ws) = start(q), start(s)

        def finish(q=q, s=s) -> torch.Tensor:   # sources live till landed
            for w in (wq, ws):
                if w is not None:
                    w.wait()
            if out.dtype == torch.float32:
                return dequantize_int8(qg, sg, impl=impl, out=out)
            return out.copy_(dequantize_int8(qg, sg, impl=impl))
        return finish
    x = cast_compute(span, torch.bfloat16 if wire == "bf16" else out.dtype)
    g, w = start(x, out) if x.dtype == out.dtype else start(x)

    def finish(x=x) -> torch.Tensor:            # source lives till landed
        if w is not None:
            w.wait()
        return g if g is out else out.copy_(g)
    return finish


def _wire_gather(span: torch.Tensor, wire: str, gather, out: torch.Tensor,
                 impl: Optional[str] = None) -> torch.Tensor:
    """One blocking param all-gather at a bucket's wire precision, decoded
    into ``out`` (``_wire_gather_start``); ``gather(x, out=None)``
    all-gathers ``x``."""
    return _wire_gather_start(
        span, wire, lambda x, o=None: (gather(x, o), None), out, impl)()


@dataclasses.dataclass
class PhaseStats:
    """Per-phase dispatch statistics (host clock, enqueue time on the
    card), one per (layout, PhaseSpec, gather mask, AG-link mask) the
    runtime has installed: JAX's phase-cache entry, kept across swaps."""

    dispatches: int = 0
    dispatch_s: float = 0.0


def _grad_leaves(layout: BucketLayout, pbuf, gbuf) -> List[torch.Tensor]:
    """Leaf tensors viewing the param buffers, whose ``.grad`` views the
    gradient buffers: backward accumulates in place into ``gbuf``."""
    out = []
    for p, g in zip(unflatten_buckets(layout, pbuf),
                    unflatten_buckets(layout, gbuf)):
        t = p.detach().requires_grad_(True)
        t.grad = g
        out.append(t)
    return out


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one side of a change of ranks keeps a flat train state: the
    global ``ranks`` holding it, in position order, the process ``group``
    over them (None: the world), the bucket ``layout`` and whether params
    and moments are ``sharded`` over the ranks (position ``p`` holds span
    ``p`` of each bucket, the layout having ``len(ranks)`` shards) or
    whole on each rank."""

    ranks: Tuple[int, ...]
    group: Any
    layout: BucketLayout
    sharded: bool

    def window(self, rank: int, b: int) -> Optional[Tuple[int, int]]:
        """The element range of bucket ``b`` that global ``rank`` holds
        (None when it holds none)."""
        if rank not in self.ranks:
            return None
        if not self.sharded:
            return 0, self.layout.buf_sizes[b]
        n = self.layout.shard_sizes[b]
        p = self.ranks.index(rank)
        return p * n, (p + 1) * n


def repack_placed(tr: LayoutTransition,
                  bufs: Optional[Sequence[torch.Tensor]], src: Placement,
                  dst: Placement, *, dtype: torch.dtype, device
                  ) -> Optional[List[torch.Tensor]]:
    """``repack_state``'s move of one state component (the param buffers
    or a moment) across a change of the ranks that hold it: this rank's
    buffers under ``dst`` (its span of each ``tr.dst`` bucket, or the
    whole bucket) from its buffers ``bufs`` under ``src`` (None on a rank
    outside ``src``); None on a rank outside ``dst``.  Every element lands
    where ``tr`` puts it, bit for bit, and padded tails are zero.

    Each src bucket some dst rank needs is made whole on the src ranks
    (an all-gather over ``src.group`` when sharded over several ranks),
    sent whole from src's first rank to each dst rank outside ``src``
    (point to point), and each dst rank copies its pieces out of it; one
    src bucket at a time, so a rank holds the component's two forms and
    at most one whole src bucket.  A dst bucket identical to a src bucket
    whose range this rank already holds is that tensor.  Collective over
    the ranks of both sides, which call it with the same arguments;
    other ranks need not."""
    me = dist.get_rank()
    nd = tr.dst.n_buckets

    def plan(rank):
        """(dst buckets ``rank`` keeps as they stand, per src bucket the
        pieces it cuts: (dst bucket, copy, lo, hi) in dst offsets)."""
        keep, cuts = set(), {}
        for b in range(nd):
            w = dst.window(rank, b)
            if tr.identical[b] and \
                    src.window(rank, tr.copies[b][0].src_bucket) == w:
                keep.add(b)
                continue
            for c in tr.copies[b]:
                lo, hi = max(c.dst_off, w[0]), min(c.dst_off + c.length, w[1])
                if lo < hi:
                    cuts.setdefault(c.src_bucket, []).append((b, c, lo, hi))
        return keep, cuts

    plans = {r: plan(r) for r in dst.ranks}
    needed = sorted({sb for _, cuts in plans.values() for sb in cuts})
    out = None
    if me in plans:
        keep, cuts = plans[me]
        out = []
        for b in range(nd):
            lo, hi = dst.window(me, b)
            if b in keep:
                out.append(bufs[tr.copies[b][0].src_bucket])
                continue
            # each element written once: the pieces below, zeros where no
            # piece lands (the padded tail)
            t = torch.empty((hi - lo,), dtype=dtype, device=device)
            at = lo
            for plo, phi in sorted([(x[2], x[3]) for ps in cuts.values()
                                    for x in ps if x[0] == b]) + [(hi, hi)]:
                if at < plo:
                    t[at - lo:plo - lo].zero_()
                at = max(at, phi)
            out.append(t)
    for sb in needed:                  # the same order on every rank
        full = None
        if me in src.ranks:
            if src.sharded and len(src.ranks) > 1:
                full = torch.empty((tr.src.buf_sizes[sb],), dtype=dtype,
                                   device=device)
                dist.all_gather_into_tensor(full, bufs[sb], group=src.group)
            else:
                full = bufs[sb]
        takers = [r for r in dst.ranks
                  if r not in src.ranks and sb in plans[r][1]]
        if me == src.ranks[0] and takers:
            for w in [dist.isend(full, dst=r) for r in takers]:
                w.wait()
        elif me in takers:
            full = torch.empty((tr.src.buf_sizes[sb],), dtype=dtype,
                               device=device)
            dist.recv(full, src=src.ranks[0])
        for b, c, lo, hi in (plans[me][1].get(sb, ()) if me in plans
                             else ()):
            w0 = dst.window(me, b)[0]
            at = c.src_off + lo - c.dst_off
            out[b][lo - w0:hi - w0] = full[at:at + hi - lo]
        del full
    return out


class DeftRuntime:
    """Runs one DeFT schedule on the flat-resident engine: replicated, or
    sharded over the ranks with ``fsdp=True``.

    ``step(i, state, batch)`` runs cycle phase ``phase_in_cycle(i)`` and
    returns (state, metrics); the state's buffers are updated in place.

    ``compute_dtype`` (None or ``torch.bfloat16``) is the forward/backward
    dtype; ``master_dtype`` ("f32" or "bf16sr", None to take the layout's)
    the resident param dtype; ``attn_impl`` / ``scan_impl`` /
    ``update_impl`` / ``quantize_impl`` = "plain" force the kernels' plain
    versions.  ``fsdp`` selects the sharded flat engine, whose layout must
    be built with ``shard_count`` equal to the 'data' group's size;
    ``gather_skip`` (None: on when the schedule has a position that can
    reuse a gather) lets it skip the param all-gathers of a phase that no
    update preceded, and ``decoupled`` streams its param gathers into the
    forward.  The replicated engine's forward reads a bf16sr master in
    bf16, the sharded one reads params at ``compute_dtype`` (f32 when
    None), as the JAX package's two engines do.

    ``group`` is the 'data' group (None: the world) and ``outer_group``
    the 'pod' group of a ``pod x data`` layout (``launch.train.pod_groups``);
    ``mesh`` (a ``launch.mesh.Mesh``) gives both, and with a 'model' axis
    above 1 runs the model tensor-parallel on this rank's shards (the
    layout built over them; ``state_from_params`` takes the global tree,
    ``params_tree`` gathers it back).
    ``secondary_chain`` (a permutation of the 'data' ranks,
    ``launch.mesh.ring_chain``) routes the secondary link's collectives
    along that chain, and ``ag_plan`` (an ``AgStreamPlan``) the sharded
    engine's param gathers it puts on link 1 (without a chain the plan
    routes nothing, as in JAX).

    ``flat_state=False`` (None: the flat engine) selects the tree-state
    engine: replicated, f32 wires, params resident at their own dtype,
    per-leaf updates (``update_impl`` "per-leaf" in :meth:`stats`).

    ``tracer`` (an ``obs.Tracer``) turns on the per-step spans: ``phase``,
    ``collective-group`` (with the bytes the phase's syncs put on each
    link), ``update-apply`` and ``gather-skip``, named and tagged as
    JAX's.  Without one, a private ring still records the control plane
    (swaps, repacks, failed builds), which ``swap_log`` reads back."""

    def __init__(self, cfg: ArchConfig, opt_spec: OptimizerSpec,
                 schedule: DeftSchedule, layout: BucketLayout, *,
                 device="cuda", group=None, outer_group=None,
                 loss_chunk: int = 0,
                 attn_impl: Optional[str] = None,
                 scan_impl: Optional[str] = None,
                 update_impl: Optional[str] = None,
                 quantize_impl: Optional[str] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 master_dtype: Optional[str] = None,
                 fsdp: bool = False,
                 gather_skip: Optional[bool] = None,
                 decoupled: bool = False,
                 secondary_chain: Optional[Sequence[int]] = None,
                 ag_plan: Any = None,
                 tracer: Optional[Tracer] = None,
                 flat_state: Optional[bool] = None,
                 mesh: Any = None):
        joint = _UNSET
        if mesh is not None:
            if group is not None or outer_group is not None:
                raise ValueError("DeftRuntime takes a mesh or its 'data' / "
                                 "'pod' groups, not both")
            group, outer_group = mesh.group("data"), mesh.group("pod")
            joint = mesh.dp_group
        self.mesh = mesh
        self.tp = ModelParallel.of(mesh)
        if self.tp is not None:
            self._refuse_model_axis(
                flat_state=flat_state,
                compute_dtype=compute_dtype, master_dtype=master_dtype,
                layout=layout, secondary_chain=secondary_chain,
                decoupled=decoupled)
        self.flat_state = True if flat_state is None else bool(flat_state)
        sharded_flat = fsdp and self.flat_state
        if gather_skip and not sharded_flat:
            raise ValueError(
                "gather_skip only applies to the sharded flat engine "
                "(fsdp=True, flat_state=True): the other engines never "
                "all-gather params")
        if decoupled and not sharded_flat:
            raise ValueError(
                "decoupled AG streaming only applies to the sharded flat "
                "engine (fsdp=True, flat_state=True): the other engines have "
                "no per-bucket param all-gather to stream (DESIGN.md §12)")
        if not self.flat_state:
            self._refuse_tree_state(fsdp, compute_dtype, update_impl,
                                    master_dtype, layout)
        chain = None
        if secondary_chain is not None:
            chain = tuple(int(p) for p in secondary_chain)
            if sorted(chain) != list(range(len(chain))):
                raise ValueError(
                    f"secondary_chain={chain} is not a permutation of "
                    f"0..{len(chain) - 1} — build it with "
                    f"launch.mesh.ring_chain")
            if outer_group is not None and not fsdp:
                raise ValueError(
                    "secondary_chain on a multi-pod layout needs the sharded "
                    "flat engine: its 'data' reduce-scatter is separate from "
                    "the pod all-reduce, so the chain swaps in exactly.  The "
                    "replicated engine syncs with ONE joint ('pod', 'data') "
                    "sum whose reduction order a per-axis chain cannot "
                    "reproduce (DESIGN.md §14)")
        self.cfg = cfg
        self.opt_spec = opt_spec
        self.layout = layout
        self.device = torch.device(device)
        self.fsdp = bool(fsdp)
        self.decoupled = bool(decoupled)
        self.secondary_chain = chain
        self.dp = DataParallel(group, DataParallel.SHARDED if self.fsdp
                               else DataParallel.REPLICATED,
                               outer=outer_group, chain=chain, joint=joint)
        if chain is not None and len(chain) != self.dp.size:
            raise ValueError(
                f"secondary_chain covers {len(chain)} positions but the "
                f"'data' axis is {self.dp.size}-way — build it with "
                f"launch.mesh.ring_chain({self.dp.size}, link)")
        self.loss_chunk = loss_chunk
        self.attn_impl = attn_impl
        self.scan_impl = scan_impl
        self.update_impl = update_impl
        self.quantize_impl = quantize_impl
        if compute_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype={compute_dtype!r}")
        self.compute_dtype = compute_dtype
        # the resident-master dtype must agree with the layout's policy
        lp_master = (layout.precision.master
                     if layout.precision is not None else None)
        if (master_dtype is not None and lp_master is not None
                and master_dtype != lp_master):
            raise ValueError(
                f"master dtype disagreement: master_dtype={master_dtype!r} "
                f"but the layout's precision policy says {lp_master!r}")
        self.master_dtype = master_dtype or lp_master or "f32"
        if self.master_dtype not in ("f32", "bf16sr"):
            raise ValueError(f"master_dtype={self.master_dtype!r}")
        # the forward reads (and autograd differentiates) this dtype
        if self.fsdp or self.master_dtype == "f32":
            self._leaf_dtype = compute_dtype or torch.float32
        else:
            self._leaf_dtype = compute_dtype or torch.bfloat16
        # the param tree this rank holds: its shards at model > 1
        self._structure = init_params(cfg, device="meta")
        self._specs = self._model_norm = None
        if self.tp is not None:
            self._specs = model_specs(self._structure, mesh)
            self._structure = shard_params(self._structure, self._specs, mesh)
        self._check_layout(layout)
        if self.tp is not None:
            self._model_norm = SpanNorm(layout, split_leaves(self._specs),
                                        self.tp)
        self.segments = (build_segments(layout, opt_spec) if self.flat_state
                         else None)
        self.gather_skip = bool(
            gather_skip if gather_skip is not None
            else self.fsdp and any(any(m) for m in
                                   _gather_reuse_masks(schedule)))
        self._ag_plan = ag_plan
        self.last_stream: Optional[Dict[str, Any]] = None
        self.last_collectives: Dict[str, int] = dict(self.dp.counts)
        self.last_p2p: List[Tuple[Tuple[int, int], ...]] = []
        self._wire_count = [0, 0]          # this step's (primary, secondary)
        self._cycle_base = 0               # step at which the cycle restarts
        # after a hand-over, each coming step's update divisor where it is
        # not its phase's update_k (``handover_divisors``)
        self._divisors: List[Optional[int]] = []
        # per (layout, PhaseSpec, gather mask, AG-link mask) ever installed,
        # its dispatch statistics: JAX's phase cache, kept across swaps
        self._entries: Dict[Tuple, PhaseStats] = {}
        # hot-swap state (JAX's prepare_swap / step protocol)
        self._pending: Optional[_PendingSwap] = None
        self._swap_gen = 0                 # a stale build does not publish
        self._swap_thread: Optional[threading.Thread] = None
        self.replans = 0                   # schedules staged via prepare_swap
        self.hot_swaps = 0                 # schedules actually installed
        self.layout_swaps = 0              # hot-swaps that re-packed state
        self.swap_failures = 0             # staged builds that failed
        self.last_swap_error: Optional[str] = None
        # control-plane events always record into the tracer (``swap_log``
        # is read back from them); per-step spans only with a tracer given
        self.tracer = tracer if tracer is not None else Tracer(capacity=8192)
        self.trace_steps = tracer is not None
        self.last_phase = 0                # cycle phase of the last dispatch
        self.last_dispatch_first = False   # last dispatch was an entry's first
        self._swap_lock = threading.Lock()
        self._install(schedule, self._schedule_keys(schedule, layout))

    @staticmethod
    def _refuse_tree_state(fsdp, compute_dtype, update_impl, master_dtype,
                           layout: BucketLayout) -> None:
        """What ``flat_state=False`` cannot run: JAX's
        ``RuntimeConfig.validate`` and precision checks, and sharded params
        (JAX's tree-state RS engine, ROADMAP item 8.3)."""
        if fsdp:
            raise ValueError(
                "fsdp=True with flat_state=False is JAX's tree-state RS "
                "engine (deft_rs_phase_step_fused: manual over 'pod', params "
                "FSDP-sharded over 'data' by logical sharding rules), which "
                "is not ported, ROADMAP item 8.3: use the sharded flat engine "
                "(flat_state=True)")
        if compute_dtype is not None:
            raise ValueError(
                "compute_dtype (mixed precision) needs the flat engine: "
                "tree-state params are resident at their init dtype — drop "
                "flat_state=False or drop compute_dtype (DESIGN.md §8)")
        if update_impl is not None:
            raise ValueError(
                "update_impl selects a fused bucket-update kernel — only the "
                "flat engine runs those; flat_state=False applies per-leaf "
                "updates")
        if master_dtype == "bf16sr":
            raise ValueError(
                "master_dtype='bf16sr' needs the flat engine: the "
                "stochastic-rounding write-back rides the fused bucket-update "
                "kernels (DESIGN.md §13)")
        p = layout.precision
        if p is not None and not p.all_f32:
            raise ValueError(
                "a non-f32 PrecisionPolicy needs the flat engines: the "
                "tree-state path has no per-bucket wire edges (DESIGN.md "
                "§13) — drop flat_state=False")

    @staticmethod
    def _refuse_model_axis(*, flat_state, compute_dtype, master_dtype,
                           layout: BucketLayout, secondary_chain,
                           decoupled) -> None:
        """What a mesh with 'model' > 1 cannot run yet (ROADMAP item 8.2):
        every engine and path but the two flat engines in f32."""
        lp = layout.precision
        refused = [name for name, on in (
            ("the tree-state engine (flat_state=False)", flat_state is False),
            ("a bf16 compute dtype",
             compute_dtype not in (None, torch.float32)),
            ("a bf16sr master", master_dtype == "bf16sr"
             or layout.master_dtype == "bf16sr"),
            ("non-f32 gradient wires", lp is not None and not lp.all_f32),
            ("a secondary ring chain", secondary_chain is not None),
            ("AG streaming (decoupled)", decoupled)) if on]
        if refused:
            raise NotImplementedError(
                f"the 'model' axis runs the flat engines in f32; "
                f"{', '.join(refused)} over it is not ported ({PATHS_ITEM})")

    def _single_model(self, what: str) -> None:
        """Refuse ``what`` at model > 1 (ROADMAP item 8.2)."""
        if self.tp is not None:
            raise NotImplementedError(
                f"{what} at model {self.tp.size} is not ported "
                f"({PATHS_ITEM})")

    def _check_layout(self, layout: BucketLayout) -> None:
        """Refuse a layout this runtime cannot run: another parameter
        tree, a precision policy whose master is not the runtime's, or, on
        the sharded engine, a shard count other than the 'data' group's
        size (a repack across shard counts changes the number of ranks)."""
        shapes = tuple(tuple(l.shape) for l in tree_leaves(self._structure))
        if shapes != layout.shapes:
            raise ValueError(
                "BucketLayout does not match this config's parameter tree"
                + (" (at model > 1 it is built over this rank's shards, "
                   "sharding.tp.shard_params)" if self.tp is not None
                   else ""))
        if layout.master_dtype != self.master_dtype \
                and layout.precision is not None:
            raise ValueError(
                f"master dtype disagreement: the runtime keeps a "
                f"{self.master_dtype!r} master but the layout's precision "
                f"policy says {layout.master_dtype!r}")
        if self.fsdp and layout.shards != self.dp.size:
            # the layout's own check keeps every span a multiple of 128
            # lanes, so the int8 wire's blockwise grid tiles each span
            raise ValueError(
                f"sharded flat engine: BucketLayout was built with "
                f"shard_count={layout.shards} but the 'data' group has "
                f"{self.dp.size} ranks — build the layout with "
                f"build_bucket_layout(..., shard_count={self.dp.size})")

    def _ag_link_masks(self, schedule: DeftSchedule
                       ) -> List[Optional[Tuple[bool, ...]]]:
        """Per cycle position, the per-bucket secondary-AG mask of the
        sharded flat engine (DESIGN.md §14): True where the param
        all-gather was planned onto the secondary link (``AgItem.link >=
        1``), so that bucket's gather runs along the ring chain.  All None
        without an AG plan, a chain or the sharded engine (as in JAX, the
        plan alone routes nothing)."""
        if (self._ag_plan is None or self.secondary_chain is None
                or not self.fsdp):
            return [None] * schedule.period
        hot: Dict[int, set] = {}
        for item in self._ag_plan.items:
            if item.link >= 1:
                hot.setdefault(item.phase, set()).add(item.bucket)
        return [tuple(b in hot[t] for b in range(len(ph.route_new)))
                if t in hot else None
                for t, ph in enumerate(schedule.phases)]

    def _schedule_keys(self, schedule: DeftSchedule, layout: BucketLayout
                       ) -> List[Tuple]:
        """Per cycle position, the phase's identity (JAX's entry key):
        (layout, PhaseSpec, gather-skip mask or None, AG-link mask or
        None)."""
        masks = (_gather_reuse_masks(schedule) if self.gather_skip
                 else [None] * schedule.period)
        links = self._ag_link_masks(schedule)
        return [(layout, ph, masks[t], links[t])
                for t, ph in enumerate(schedule.phases)]

    def _ensure_entries(self, schedule: DeftSchedule, layout: BucketLayout
                        ) -> Tuple[int, int]:
        """Create the statistics of the schedule's phases this runtime has
        never installed under ``layout``: (new, reused) positions."""
        new = reused = 0
        for key in self._schedule_keys(schedule, layout):
            if key in self._entries:
                reused += 1
            else:
                self._entries[key] = PhaseStats()
                new += 1
        return new, reused

    def _install(self, schedule: DeftSchedule, keys: List[Tuple]) -> None:
        """Make ``schedule`` the running one under ``self.layout``, whose
        per-position phase identities are ``keys`` (``_schedule_keys``):
        its masks, phase table, collective counts and planned wire bytes,
        resolved once here so that ``step`` only indexes."""
        for key in keys:
            self._entries.setdefault(key, PhaseStats())
        self.schedule = schedule
        # per cycle position: the gather-skip mask (None with the skip
        # off) and the secondary-AG mask
        self._reuse = [k[2] for k in keys]
        self._ag_links = [k[3] for k in keys]
        # per cycle position, the buckets' first-touch order of its first
        # streamed dispatch (the order the gathers are issued ahead in)
        self._touch_order: List[Optional[Tuple[int, ...]]] = \
            [None] * schedule.period
        index_of: Dict[Tuple, int] = {}
        for key in keys:
            index_of.setdefault(key, len(index_of))
        self._unique = [self._entries[key] for key in index_of]
        self.phase_of_step = tuple(index_of[key] for key in keys)
        self._reuse_of_step = tuple(m is not None and any(m)
                                    for m in self._reuse)
        self._coll_of_step = tuple(phase_collectives(ph)
                                   for ph in schedule.phases)
        self._wire_bytes_split_of_step = tuple(
            wire_bytes_split_of_phase(ph, self.layout)
            for ph in schedule.phases)

    @property
    def period(self) -> int:
        return self.schedule.period

    @property
    def n_unique_phases(self) -> int:
        return len(self._unique)

    @property
    def n_cached_phases(self) -> int:
        """Phases ever installed, across every schedule and layout."""
        return len(self._entries)

    @property
    def wire_bytes_per_phase(self) -> Tuple[int, ...]:
        """Planned bytes on the wire per cycle phase under the installed
        layout's precision (what ``obs.wire_bytes_report`` audits the
        trace against)."""
        return tuple(p + s for p, s in self._wire_bytes_split_of_step)

    @property
    def wire_bytes_split_per_phase(self) -> Tuple[Tuple[int, int], ...]:
        """Planned (primary, secondary) wire bytes per cycle phase: the
        per-link vector ``obs.wire_bytes_report`` takes as
        ``planned_split``."""
        return self._wire_bytes_split_of_step

    @property
    def swap_log(self) -> List[Dict[str, Any]]:
        """The swap-log dicts of JAX's runtime, read back from the trace:
        one per ``swap-install`` event and per failed or abandoned build
        (the ``swap-compile`` events carrying an ``event`` attr)."""
        out: List[Dict[str, Any]] = []
        for sp in self.tracer.spans(("swap-install", "swap-compile")):
            if sp.kind == "swap-install" or "event" in sp.args:
                out.append({"step": sp.step, **sp.args})
        return out

    def placement(self) -> Placement:
        """Where this runtime keeps its state: the global ranks of its
        'data' group (under a pod axis, this rank's pod's; each pod holds
        the whole state)."""
        self._single_model("an elastic move (placement)")
        g = self.dp.group
        ranks = tuple(r if g is None else dist.get_global_rank(g, r)
                      for r in range(self.dp.size))
        return Placement(ranks, g, self.layout, self.fsdp)

    @property
    def accum_devices(self) -> int:
        """Rows of a checkpoint's accumulator stacks: every DP rank's."""
        return self.dp.n_dp

    def reset_cycle(self, step: int) -> None:
        """Restart the schedule cycle at ``step``: a restored run that
        cannot continue mid-cycle begins a fresh cycle there (position 0,
        which always gathers)."""
        self._cycle_base = step

    @property
    def pending_divisors(self) -> List[Optional[int]]:
        """The update divisors a hot swap's hand-over still owes the coming
        steps, first the next step's (``handover_divisors``); a checkpoint
        taken inside that window carries them, and a mid-cycle resume
        sets them back."""
        return list(self._divisors)

    @pending_divisors.setter
    def pending_divisors(self, divisors) -> None:
        self._divisors = list(divisors)

    def phase_in_cycle(self, i: int) -> int:
        """The cycle position step ``i`` dispatches."""
        return (i - self._cycle_base) % self.period

    # ---- state -----------------------------------------------------------
    def state_from_params(self, params) -> TrainState:
        """Train state whose param buffers hold ``params`` (a tree),
        promoted into the f32 master; a bf16sr master is then rounded
        down bucket by bucket by the stochastic-rounding kernel, with seed
        b + 1 as JAX's ``_round_master``, over the whole buffer.  The
        sharded engine keeps this rank's span of each rounded buffer and
        allocates its moments at span length (1/N residency); ``cur``,
        ``fut`` and the gradient buffers are full length on every rank.
        The tree-state engine keeps a copy of ``params`` on the device, at
        their own dtype, beside f32 moment trees.  At model > 1 ``params``
        is the global tree, of which each rank keeps its shards."""
        if not self.flat_state:
            return self._tree_state(tree_map(
                lambda p: p.detach().to(self.device, copy=True), params))
        if self.tp is not None:
            params = shard_params(params, self._specs, self.mesh)
        leaves = [p.to(self.device) for p in tree_leaves(params)]
        layout = self.layout
        pbuf = []
        for b in range(layout.n_buckets):
            buf = flatten_bucket(layout, leaves, b)
            if self.master_dtype == "bf16sr":
                buf = stochastic_round_bf16(buf, b + 1,
                                            impl=self.quantize_impl)
            if self.fsdp:
                span = layout.shard_sizes[b]
                buf = buf[self.dp.rank * span:(self.dp.rank + 1) * span].clone()
            pbuf.append(buf)
        del leaves
        acc = init_fused_accumulators(layout, self.device)
        state = {
            "pbuf": tuple(pbuf),
            "opt": init_flat_opt_state(
                self.opt_spec,
                layout.shard_sizes if self.fsdp else layout.buf_sizes,
                self.device),
            "cur": acc["cur"],
            "fut": acc["fut"],
            "gbuf": tuple(torch.zeros((n,), dtype=torch.float32,
                                      device=self.device)
                          for n in layout.buf_sizes),
        }
        if self.gather_skip:
            state["pgather"] = self._init_pgather(self.layout)
        return state

    def _tree_state(self, params) -> TrainState:
        """The tree-state engine's state around ``params`` (its own
        tensors, on the device): ``{params, opt, cur, fut}``."""
        return {"params": params, "opt": init_opt_state(self.opt_spec, params),
                **init_fused_accumulators(self.layout, self.device)}

    def _master_torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.master_dtype == "bf16sr" \
            else torch.float32

    def _init_pgather(self, layout: BucketLayout
                      ) -> Tuple[torch.Tensor, ...]:
        """Cold gather cache under ``layout``: full zero buffers of the
        forward's dtype.  Position 0 of a cycle always gathers into them
        before any phase reads them; the engine gathers into these buffers
        in place, so the cache is the gathered tensors themselves."""
        return tuple(torch.zeros((n,), dtype=self._leaf_dtype,
                                 device=self.device)
                     for n in layout.buf_sizes)

    def init_state(self, seed: int = 0,
                   dtype: torch.dtype = torch.float32) -> TrainState:
        """Fresh state from params drawn at ``dtype`` (the compute dtype
        of a mixed-precision run: the init rounding), promoted into the
        master.  The tree-state engine keeps them resident at ``dtype``,
        any dtype."""
        if not self.flat_state:
            return self._tree_state(init_params(
                self.cfg, seed=seed, device=self.device, dtype=dtype))
        if dtype != torch.float32 and dtype != self.compute_dtype:
            raise ValueError(
                f"the master is promoted from params drawn at {dtype}; that "
                f"needs the runtime built with compute_dtype={dtype} (got "
                f"{self.compute_dtype})")
        return self.state_from_params(
            init_params(self.cfg, seed=seed, device=self.device, dtype=dtype))

    def params_tree(self, state: TrainState):
        """Parameter tree of views into the param buffers.  On the sharded
        engine the spans are all-gathered into new full buffers first: a
        collective, which every rank must call.  At model > 1 the leaves
        split over 'model' are all-gathered into the global tree (JAX's
        arrays; a collective too).  A tree state's params are the tree
        itself."""
        if not self.flat_state:
            return state["params"]
        pbuf = state["pbuf"]
        if self.fsdp:
            pbuf = [self.dp.all_gather(p) for p in pbuf]
        tree = tree_unflatten(self._structure,
                              unflatten_buckets(self.layout, pbuf))
        if self.tp is not None:
            tree = gather_params(tree, self._specs, self.tp)
        return tree

    # ---- checkpoint form -----------------------------------------------
    @property
    def writer(self) -> int:
        """The global rank that writes this runtime's checkpoints: the
        lowest of its joint DP group (rank 0 over the world; the lowest
        survivor after an elastic migration)."""
        joint = self.dp.joint
        return 0 if joint is None else dist.get_global_rank(joint, 0)

    def _to_writer(self, buf: torch.Tensor, group) -> Optional[torch.Tensor]:
        """Every rank of ``group``'s ``buf`` (one size on all of them) as
        the rows of a host stack on the :attr:`writer`; None elsewhere.
        The rows arrive one rank at a time through one device buffer of
        ``buf``'s size, so no device holds more than one extra ``buf``;
        the other ranks send theirs (point to point, uncounted), and a
        group without the writer moves nothing."""
        me, size = dist.get_rank(), dist.get_world_size(group)
        ranks = [r if group is None else dist.get_global_rank(group, r)
                 for r in range(size)]
        writer = self.writer
        if writer not in ranks:
            return None
        if me != writer:
            dist.send(buf, dst=writer, group=None)
            return None
        host = torch.empty((size, buf.numel()), dtype=buf.dtype)
        tmp = torch.empty_like(buf) if size > 1 else None
        for r, g in enumerate(ranks):
            if g == writer:
                host[r].copy_(buf)
            else:
                dist.recv(tmp, src=g)
                host[r].copy_(tmp)
        return host

    def state_to_tree(self, state: TrainState) -> Optional[TrainState]:
        """The JAX package's checkpoint form of a train state, on the host
        of the :attr:`writer` (None on the other ranks): ``{params,
        opt{step, m[, v]}, cur, fut[, pgather]}``.  Refused at model > 1
        (ROADMAP item 8.2).
        Params and moments are layout-free trees (at the master dtype and
        f32); ``cur``/``fut`` are ``(accum_devices, n)`` stacks of every DP
        rank's buffer, row ``r`` the joint ('pod', 'data') rank ``r``, and
        ``pgather`` one full buffer per bucket at the forward's dtype, all
        bound to this runtime's layout.

        Collective: every rank of the runtime calls it.  The writer
        receives each bucket (the sharded engine's spans, each accumulator
        row) one rank at a time into a device buffer the size of the
        bucket's span or row, and copies it to its host; the others only
        send.  So each device holds at most one span or row more than its
        state, and only the writer's host holds the tree.  A tree state
        gives host copies of its own params and moments (JAX's tree form is
        the state itself)."""
        self._single_model("a checkpoint save (state_to_tree)")
        layout, dp = self.layout, self.dp
        writer = dist.get_rank() == self.writer
        if not self.flat_state:
            acc = {k: tuple(self._to_writer(c, dp.joint) for c in state[k])
                   for k in ("cur", "fut")}
            if not writer:
                return None
            host = lambda t: tree_map(lambda x: x.to("cpu", copy=True), t)
            return {"params": host(state["params"]),
                    "opt": host(state["opt"]), **acc}

        def full(buf):
            if self.fsdp:
                rows = self._to_writer(buf, dp.group)
                return None if rows is None else rows.reshape(-1)
            return buf.to("cpu", copy=True) if writer else None

        def tree_of(bufs):
            leaves: List[torch.Tensor] = [None] * layout.n_leaves  # type: ignore
            for b in range(layout.n_buckets):
                host = full(bufs[b])
                if host is None:
                    continue
                for i, off in zip(layout.leaves[b], layout.offsets[b]):
                    shape = layout.shapes[i]
                    leaves[i] = host[off:off + math.prod(shape)].view(shape)
            return tree_unflatten(self._structure, leaves)

        opt = {"m": tree_of(state["opt"]["m"])}
        if "v" in state["opt"]:
            opt["v"] = tree_of(state["opt"]["v"])
        out = {"params": tree_of(state["pbuf"]), "opt": opt,
               "cur": tuple(self._to_writer(c, dp.joint)
                            for c in state["cur"]),
               "fut": tuple(self._to_writer(f, dp.joint)
                            for f in state["fut"])}
        if not writer:
            return None
        opt["step"] = state["opt"]["step"].to("cpu", copy=True)
        if "pgather" in state:
            # a mid-cycle resume at a reuse position reads the cache
            out["pgather"] = tuple(p.to("cpu", copy=True)
                                   for p in state["pgather"])
        return out

    def tree_to_state(self, tree_state: TrainState,
                      src_layout: Optional[BucketLayout] = None
                      ) -> TrainState:
        """Inverse of :meth:`state_to_tree`: this rank's resident state,
        on the runtime's device, from a checkpoint tree (host or device
        tensors, left untouched).

        Params and moments re-flatten under this layout (this rank's span
        on the sharded engine; a bf16sr master's bf16 values promote
        exactly and cast back bit for bit).  The accumulators take row
        ``rank`` of each stack, routed through the
        :class:`~repro_torch.train.bucketing.LayoutTransition` when
        ``src_layout`` (the layout the checkpoint was written under)
        differs from this runtime's; a cross-layout restore starts the gather
        cache cold.  ``gbuf`` is zero, as the engines leave the retired
        generation between steps.  A tree state takes the params at their
        saved dtype and the moments as trees."""
        self._single_model("a checkpoint restore (tree_to_state)")
        layout, dp = self.layout, self.dp
        dev = lambda x, dt=None: x.to(device=self.device,
                                      dtype=dt or x.dtype, copy=True)
        cross = src_layout is not None and src_layout != layout
        row = dist.get_rank(dp.joint)
        cur = [c[row] for c in tree_state["cur"]]
        fut = [f[row] for f in tree_state["fut"]]
        if cross:
            tr = build_layout_transition(src_layout, layout)
            cur, fut = repack_buffers(tr, cur), repack_buffers(tr, fut)
        f32 = torch.float32
        if not self.flat_state:
            on_dev = lambda t, dt=None: tree_map(lambda x: dev(x, dt), t)
            opt = {k: (on_dev(v, torch.int32) if k == "step"
                       else on_dev(v, f32))
                   for k, v in tree_state["opt"].items()}
            return {"params": on_dev(tree_state["params"]), "opt": opt,
                    "cur": tuple(dev(c, f32) for c in cur),
                    "fut": tuple(dev(f, f32) for f in fut)}

        def bufs_of(tree, dtype):
            leaves = tree_leaves(tree)
            out = []
            for b in range(layout.n_buckets):
                buf = flatten_bucket(layout, leaves, b)
                if self.fsdp:
                    span = layout.shard_sizes[b]
                    buf = buf[dp.rank * span:(dp.rank + 1) * span]
                out.append(dev(buf, dtype))
            return tuple(out)

        opt = {"step": dev(tree_state["opt"]["step"], torch.int32),
               "m": bufs_of(tree_state["opt"]["m"], f32)}
        if "v" in tree_state["opt"]:
            opt["v"] = bufs_of(tree_state["opt"]["v"], f32)
        out = {"pbuf": bufs_of(tree_state["params"],
                               self._master_torch_dtype()),
               "opt": opt,
               "cur": tuple(dev(c, f32) for c in cur),
               "fut": tuple(dev(f, f32) for f in fut),
               "gbuf": tuple(torch.zeros((n,), dtype=f32, device=self.device)
                             for n in layout.buf_sizes)}
        if self.gather_skip:
            if not cross and "pgather" in tree_state:
                out["pgather"] = tuple(dev(p, self._leaf_dtype)
                                       for p in tree_state["pgather"])
            else:
                out["pgather"] = self._init_pgather(self.layout)
        return out

    def checkpoint_struct(self, src_layout: Optional[BucketLayout] = None,
                          *, with_pgather: Optional[bool] = None
                          ) -> TrainState:
        """Meta tensors shaped as :meth:`state_to_tree`'s output written
        under ``src_layout`` (default: this runtime's layout): the ``like``
        of ``checkpoint.restore``.  ``with_pgather`` says whether the
        checkpoint carries the gather cache; by default only a same-layout
        restore on a gather-skip runtime reads it.  Refused on the
        tree-state engine, as JAX's is: its checkpoint form is its state,
        whose params keep the dtype they were drawn at, so a
        ``state_to_tree`` of a fresh state is the ``like``."""
        self._single_model("a checkpoint restore (checkpoint_struct)")
        if not self.flat_state:
            raise ValueError(
                "checkpoint_struct needs a flat-state runtime: a tree state "
                "is its own checkpoint form — restore with like=state_to_tree"
                "(init_state()) of this runtime")
        lay = src_layout or self.layout
        if with_pgather is None:
            with_pgather = self.gather_skip and lay == self.layout
        meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
        f32 = torch.float32
        tree = lambda dt: tree_unflatten(
            self._structure, [meta(s, dt) for s in lay.shapes])
        opt: Dict[str, Any] = {"step": meta((), torch.int32), "m": tree(f32)}
        if self.opt_spec.name == "adamw":
            opt["v"] = tree(f32)
        acc = lambda: tuple(meta((self.accum_devices, n), f32)
                            for n in lay.buf_sizes)
        out = {"params": tree(self._master_torch_dtype()), "opt": opt,
               "cur": acc(), "fut": acc()}
        if with_pgather:
            out["pgather"] = tuple(meta((n,), self._leaf_dtype)
                                   for n in lay.buf_sizes)
        return out

    # ---- layout changes and hot swaps ----------------------------------
    def repack_state(self, state: TrainState, transition: LayoutTransition,
                     src_schedule: Optional[DeftSchedule] = None
                     ) -> TrainState:
        """Re-flatten a train state from ``transition.src`` to
        ``transition.dst`` (DESIGN.md §9): every element lands where
        flatten(unflatten(state)) under the dst layout puts it, bit for
        bit.  Consumes ``state``: its dicts are updated in place, one
        component at a time (``pbuf``, ``m``, ``v``, ``cur``, ``fut``),
        each source tuple dropped before the next is built, so the card
        holds at most one component more than the state.  A dst bucket
        identical to a src bucket is that src tensor, so a layout change
        of wire precision alone moves nothing.  ``gbuf`` is allocated
        zero under the dst layout and the gather cache starts cold
        (position 0 of a cycle always gathers).

        On the sharded engine at N ranks a dst span draws elements from
        other ranks' spans: each src bucket is all-gathered over 'data'
        once, this rank's dst pieces are copied out of it and it is
        freed, so the card holds one component's spans and one full
        bucket more.  Both layouts must
        have the 'data' group's shard count.  Collective there: every
        rank calls it.  Normally driven by the staged swap in
        :meth:`step`; public for references, restores and tests.

        ``src_schedule``, the schedule ``state`` was stepped under to a
        cycle boundary, hands its accumulators over to this runtime's
        schedule first (:meth:`hand_over`), as the staged swap does."""
        self._single_model("a repack (repack_state)")
        self._check_transition(transition)
        if src_schedule is not None:
            self.hand_over(state, src_schedule, transition)
        return self._repack(state, transition)

    def hand_over(self, state: TrainState, src_schedule: DeftSchedule,
                  transition: Optional[LayoutTransition] = None) -> None:
        """Hand ``state``'s accumulators, as ``src_schedule`` left them at a
        cycle boundary under the layout in force (``transition.src``),
        over to this runtime's schedule, whose cycle this runtime then
        steps from position 0: the updates until its own generations
        stand divide by the steps their generations hold
        (``handover_divisors``), and ``cur``'s sync state is made what
        this schedule's first cycle expects (:meth:`_hand_over_cur`).  The
        staged swap's install does it; so does ``repack_state`` given
        ``src_schedule``, and a reference that switches schedules by hand
        without a layout change calls it itself."""
        self._single_model("a hot swap's hand-over")
        self._divisors = handover_divisors(src_schedule, self.schedule)
        self._hand_over_cur(state, src_schedule, self.schedule, transition)

    def _check_transition(self, transition: LayoutTransition) -> None:
        self._check_layout(transition.dst)
        if self.fsdp and transition.src.shards != self.dp.size:
            raise ValueError(
                f"sharded flat engine: the transition's source layout has "
                f"shard_count={transition.src.shards} but the 'data' group "
                f"has {self.dp.size} ranks; a repack across shard counts "
                f"changes the number of ranks")

    def _hand_over_cur(self, state: TrainState, src: DeftSchedule,
                       dst: DeftSchedule,
                       tr: Optional[LayoutTransition]) -> None:
        """Make ``state['cur']``, as a cycle of ``src`` leaves it under the
        layout in force (``tr.src``; the same layout when ``tr`` is None),
        what the first cycle of ``dst`` expects of each element: an element
        already summed over the DP ranks that ``dst`` sums again is kept on
        DP rank 0 and zeroed on the others, and a rank-local element that
        ``dst`` applies as summed is summed now.  Without this the first
        case counts N times at N ranks.  In place, before the repack;
        nothing at one DP rank, where a sum is the identity.  Collective:
        every rank calls it, in the same order of pieces."""
        if self.dp.n_dp == 1:
            return
        have, want = _cur_at_boundary(src), _cur_reading(dst)
        lead = dist.get_rank(self.dp.joint) == 0
        pieces = ([(b, 0, n, b) for b, n in enumerate(self.layout.buf_sizes)]
                  if tr is None else
                  [(c.src_bucket, c.src_off, c.length, b)
                   for b, cs in enumerate(tr.copies) for c in cs])
        cur = state["cur"]
        for sb, off, n, b in pieces:
            x = cur[sb][off:off + n]
            if have[sb] == "summed" and want[b] == "local" and not lead:
                x.zero_()
            elif have[sb] == "local" and want[b] == "summed":
                dist.all_reduce(x, group=self.dp.joint)

    def _repack(self, state: TrainState, tr: LayoutTransition,
                src: Optional[Placement] = None,
                dst: Optional[Placement] = None, *,
                span: str = "repack-state", **args) -> Optional[TrainState]:
        """Move ``state`` across ``tr`` from ``src`` to ``dst`` (this
        runtime's placement under ``tr.src`` and ``tr.dst`` by default) and
        finish it under ``tr.dst``; None on a rank outside ``dst``.

        Component by component (``pbuf``, ``m``, ``v``, ``cur``, ``fut``)
        through :func:`repack_placed`, each source tuple dropped before the
        next is built; the accumulator rows are rank-local and already on
        ``dst``'s ranks, so each is re-flattened where it lies.  Then the
        derived buffers: ``gbuf`` zero under ``tr.dst``, the gather cache
        cold (position 0 of a cycle always gathers), and a ``span`` span
        of kind 'repack' carrying ``args``.  The shared tail of
        :meth:`repack_state`, the staged swap's install and
        :func:`~repro_torch.elastic.coordinator.migrate_state`; collective
        over the ranks of both sides.  A tree state re-flattens only its
        accumulators: its params and moments are layout-free trees, passed
        through (``_move_trees`` across a change of ranks)."""
        if src is None:
            here = self.placement()
            src = dataclasses.replace(here, layout=tr.src)
            dst = dataclasses.replace(here, layout=tr.dst)
        tr0 = self.tracer.now()
        # the derived buffers go first: rebuilt, not moved
        state.pop("gbuf", None)
        state.pop("pgather", None)
        opt = state["opt"]
        rows = (dataclasses.replace(dst, layout=tr.src, sharded=False),
                dataclasses.replace(dst, sharded=False))
        f32 = torch.float32
        comps = []
        if self.flat_state:
            comps += [(state, "pbuf", self._master_torch_dtype(), (src, dst)),
                      (opt, "m", f32, (src, dst))]
            if self.opt_spec.name == "adamw":
                comps.append((opt, "v", f32, (src, dst)))
        else:
            self._move_trees(state, src, dst)
        comps += [(state, "cur", f32, rows), (state, "fut", f32, rows)]
        for holder, key, dtype, (a, b) in comps:
            bufs = holder.pop(key, None)               # the last reference
            out = repack_placed(tr, bufs, a, b, dtype=dtype,
                                device=self.device)
            del bufs
            if out is not None:
                holder[key] = tuple(out)
        if dist.get_rank() not in dst.ranks:
            return None
        if self.flat_state:
            state["gbuf"] = tuple(torch.zeros((n,), dtype=torch.float32,
                                              device=self.device)
                                  for n in tr.dst.buf_sizes)
        if self.gather_skip:
            state["pgather"] = self._init_pgather(tr.dst)
        self._sync_device()
        self.tracer.add("repack", span, tr0, self.tracer.now(), **args,
                        moved_elems=tr.moved_elems,
                        n_buckets=tr.dst.n_buckets)
        return state

    def _move_trees(self, state: TrainState, src: Placement,
                    dst: Placement) -> None:
        """A tree state's params and moments across a change of ranks, in
        place: whole on every rank, so a rank new to the state receives
        each leaf from ``src``'s first rank (point to point, the params'
        dtype first), and a rank outside ``dst`` drops them.  Collective
        over the ranks of both sides, in leaf order."""
        me = dist.get_rank()
        takers = [r for r in dst.ranks if r not in src.ranks]
        if takers and (me == src.ranks[0] or me in takers):
            names = ("m", "v") if self.opt_spec.name == "adamw" else ("m",)
            dtypes = (torch.float32, torch.bfloat16, torch.float16)
            code = torch.zeros((1,), dtype=torch.int32, device=self.device)
            if me == src.ranks[0]:
                code[0] = dtypes.index(
                    tree_leaves(state["params"])[0].dtype)
                trees = [state["params"]] + [state["opt"][k] for k in names]
                sends = [dist.isend(code, dst=r) for r in takers]
                sends += [dist.isend(x, dst=r) for t in trees
                          for x in tree_leaves(t) for r in takers]
                for w in sends:
                    w.wait()
            else:
                dist.recv(code, src=src.ranks[0])

                def receive(dtype):
                    leaves = []
                    for x in tree_leaves(self._structure):
                        t = torch.empty(x.shape, dtype=dtype,
                                        device=self.device)
                        dist.recv(t, src=src.ranks[0])
                        leaves.append(t)
                    return tree_unflatten(self._structure, leaves)
                state["params"] = receive(dtypes[int(code[0])])
                for k in names:
                    state["opt"][k] = receive(torch.float32)
        if me not in dst.ranks:
            state.pop("params", None)
            for k in ("m", "v"):
                state["opt"].pop(k, None)

    def _sync_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _load_kernels(self, layout: BucketLayout) -> None:
        """Load (building if missing) the kernel libraries a step under
        ``layout`` launches that the layout change can bring in: the
        bucket update and, for an int8 wire or a bf16sr master, the
        quantize library.  Nothing on the CPU, where the plain versions
        run."""
        if self.device.type != "cuda" or not self.flat_state:
            return
        from repro_torch.kernels import build

        if self.update_impl != "plain":
            build.library("bucket_update")
        if self.quantize_impl != "plain" and (
                self.master_dtype == "bf16sr"
                or any(layout.wire(b) == "int8"
                       for b in range(layout.n_buckets))):
            build.library("quantize")

    def _stage(self, schedule: DeftSchedule, layout: Optional[BucketLayout],
               transition: Optional[LayoutTransition]) -> _PendingSwap:
        """Build a staged swap: the segments of a new layout, the staged
        schedule's masks and phase table, and the kernel libraries it
        needs loaded."""
        target = layout or self.layout
        self._load_kernels(target)
        return _PendingSwap(
            schedule=schedule, keys=self._schedule_keys(schedule, target),
            layout=layout, transition=transition,
            segments=(build_segments(layout, self.opt_spec)
                      if layout is not None and self.flat_state else None))

    def prepare_swap(self, schedule: DeftSchedule, *,
                     background: bool = False,
                     layout: Optional[BucketLayout] = None,
                     retries: int = 2,
                     retry_backoff_s: float = 0.05) -> Dict[str, Any]:
        """Stage a replanned schedule for installation at the next cycle
        boundary (JAX's ``prepare_swap``, without its ``state`` and
        ``batch``: nothing here depends on their shapes).

        The build (``_stage``) runs here, or on a daemon thread with
        ``background=True`` while training keeps stepping the installed
        schedule; the swap arms only once built, so :meth:`step` never
        meets a half-built schedule, and a newer ``prepare_swap``
        supersedes an older one.  A failed build is recorded as a
        ``swap-compile-failed`` event (``swap_log``, ``swap_failures``)
        and retried ``retries`` times with linear backoff, then abandoned
        (``swap-abandoned``): the installed schedule keeps running.

        ``layout`` (another :class:`BucketLayout` of the same tree: a new
        partition and/or wire precision, the same master dtype and, on the
        sharded engine, the same shard count) makes it a layout-changing
        swap: at the boundary :meth:`step` re-packs the state in place
        (:meth:`repack_state`) before dispatching phase 0 of the new
        schedule.  Either way the accumulators are handed over to the new
        schedule there (:meth:`_hand_over_cur`)."""
        self._single_model("a hot swap (prepare_swap)")
        new_layout = transition = None
        if layout is not None and layout != self.layout:
            self._check_layout(layout)
            new_layout = layout
            transition = build_layout_transition(self.layout, layout)
        new, reused = self._ensure_entries(schedule,
                                           new_layout or self.layout)
        self.replans += 1
        info: Dict[str, Any] = {"new_phases": new, "reused_phases": reused,
                                "background": background,
                                "layout_change": new_layout is not None}
        if new_layout is not None:
            info["n_buckets"] = (self.layout.n_buckets, new_layout.n_buckets)
            info["shards"] = (self.layout.shards, new_layout.shards)
            info["moved_elems"] = transition.moved_elems
        with self._swap_lock:
            self._swap_gen += 1
            gen = self._swap_gen
            self._pending = None       # a newer replan supersedes an armed one

        def build() -> None:
            t0 = time.perf_counter()
            tr0 = self.tracer.now()
            attempt = 0
            while True:
                try:
                    pending = self._stage(schedule, new_layout, transition)
                    break
                except Exception as e:   # noqa: BLE001 — recorded, retried
                    attempt += 1
                    self.swap_failures += 1
                    err = f"{type(e).__name__}: {e}"
                    self.last_swap_error = err
                    retrying = attempt <= retries and self._swap_gen == gen
                    self.tracer.instant(
                        "swap-compile", "swap-compile-failed", step=None,
                        event="swap-compile-failed", error=err,
                        attempt=attempt, retrying=retrying)
                    if not retrying:
                        elapsed = time.perf_counter() - t0
                        info.update(compile_s=elapsed,
                                    compile_attempts=attempt, abandoned=True)
                        self.tracer.instant(
                            "swap-compile", "swap-abandoned", step=None,
                            event="swap-abandoned", error=err,
                            attempts=attempt, elapsed_s=elapsed,
                            superseded=self._swap_gen != gen)
                        return
                    time.sleep(retry_backoff_s * attempt)
            info["compile_s"] = time.perf_counter() - t0
            info["compile_attempts"] = attempt + 1
            self.tracer.add(
                "swap-compile", "swap-compile", tr0, self.tracer.now(),
                new_phases=new, reused_phases=reused, background=background,
                layout_change=new_layout is not None, attempts=attempt + 1)
            with self._swap_lock:      # publish last, unless superseded
                if self._swap_gen == gen:
                    self._pending = pending

        if background:
            self._swap_thread = threading.Thread(
                target=build, name="deft-swap-build", daemon=True)
            self._swap_thread.start()
        else:
            build()
        return info

    def swap_ready(self) -> bool:
        """A staged schedule is built and armed for the next cycle
        boundary."""
        return self._pending is not None

    def wait_swap_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until a background ``prepare_swap`` finishes its build."""
        if self._swap_thread is not None:
            self._swap_thread.join(timeout)
        return self.swap_ready()

    def _install_pending(self, i: int, state: TrainState) -> TrainState:
        """Install the armed swap at step ``i`` (a cycle boundary): hand the
        accumulators over to the new schedule, re-pack the state under a
        new layout, then restart the cycle on the new schedule."""
        with self._swap_lock:
            pending, self._pending = self._pending, None
        if pending is None:                # superseded since step looked
            return state
        self._hand_over_cur(state, self.schedule, pending.schedule,
                            pending.transition)
        self._divisors = handover_divisors(self.schedule, pending.schedule)
        repack_s = None
        if pending.layout is not None:
            self._sync_device()
            t0 = time.perf_counter()
            state = self._repack(state, pending.transition,
                                 span="swap-repack", step=i)
            repack_s = time.perf_counter() - t0
            self.layout = pending.layout
            self.segments = pending.segments
            self.layout_swaps += 1
        self._install(pending.schedule, pending.keys)
        self._cycle_base = i
        self.hot_swaps += 1
        self.tracer.instant(
            "swap-install", "swap-install", step=i,
            period=pending.schedule.period,
            updates_per_period=pending.schedule.updates_per_period,
            n_buckets=self.layout.n_buckets, shards=self.layout.shards,
            repack_s=repack_s, precision=self._precision_name())
        return state

    def spawn(self, *, group: Any = _UNSET, outer_group: Any = _UNSET,
              secondary_chain: Any = _UNSET,
              schedule: Optional[DeftSchedule] = None,
              layout: Optional[BucketLayout] = None,
              fsdp: Optional[bool] = None,
              gather_skip: Optional[bool] = None,
              decoupled: Optional[bool] = None,
              tracer: Optional[Tracer] = None) -> "DeftRuntime":
        """A sibling runtime: this one's arch, optimizer, device, kernels
        and precision, with the named knobs overridden (``group`` /
        ``outer_group`` / ``secondary_chain`` in place of JAX's mesh) and
        the state form (``flat_state``) kept.  An
        inherited ``decoupled`` dies with the sharded engine; the sibling
        re-resolves its gather skip against its own schedule unless
        pinned, and shares this tracer when per-step tracing is on.  An
        illegal combination raises in the sibling's constructor, before
        any state exists.  No phase statistics are shared."""
        self._single_model("a sibling runtime (spawn)")
        fsdp_r = self.fsdp if fsdp is None else fsdp
        dec_r = self.decoupled if decoupled is None else decoupled
        if decoupled is None and not fsdp_r:
            dec_r = False
        keep = lambda v, mine: mine if v is _UNSET else v
        return DeftRuntime(
            self.cfg, self.opt_spec,
            self.schedule if schedule is None else schedule,
            self.layout if layout is None else layout,
            device=self.device, group=keep(group, self.dp.group),
            outer_group=keep(outer_group, self.dp.outer),
            loss_chunk=self.loss_chunk, attn_impl=self.attn_impl,
            scan_impl=self.scan_impl, update_impl=self.update_impl,
            quantize_impl=self.quantize_impl,
            compute_dtype=self.compute_dtype, master_dtype=self.master_dtype,
            fsdp=fsdp_r, gather_skip=gather_skip, decoupled=dec_r,
            secondary_chain=keep(secondary_chain, self.secondary_chain),
            ag_plan=self._ag_plan,
            tracer=(tracer if tracer is not None
                    else self.tracer if self.trace_steps else None),
            flat_state=self.flat_state)

    # ---- one phase ---------------------------------------------------------
    def step(self, i: int, state: TrainState, batch
             ) -> Tuple[TrainState, Dict[str, Any]]:
        """Run step ``i`` (cycle phase ``phase_in_cycle(i)``).  If a staged
        swap is armed and ``i`` lands on a cycle boundary, it is installed
        first and ``i`` becomes position 0 of the new cycle."""
        if self._pending is not None \
                and (i - self._cycle_base) % self.period == 0:
            state = self._install_pending(i, state)
        off = self.phase_in_cycle(i)
        phase = self.schedule.phases[off]
        k = (self._divisors.pop(0) if self._divisors else None) \
            or phase.update_k
        self.last_phase = off
        entry = self._unique[self.phase_of_step[off]]
        # a phase's first dispatch carries one-off work (kernel loads,
        # allocator growth): tagged, so telemetry can leave it out
        first = entry.dispatches == 0
        self.last_dispatch_first = first
        clock = self.tracer.now if self.trace_steps else time.perf_counter
        t0 = clock()
        self.dp.reset()
        self._wire_count = [0, 0]
        if not self.flat_state:
            new_state, loss, parts = self._step_tree(phase, state, batch, k)
        elif self.fsdp:
            new_state, loss, parts = self._step_sharded(off, phase, state,
                                                        batch, k)
        else:
            new_state, loss, parts = self._step_replicated(phase, state,
                                                           batch, k)
        metrics = _fused_metrics(loss, parts, phase, self.dp.n_dp, self.dp)
        t1 = clock()
        entry.dispatches += 1
        entry.dispatch_s += t1 - t0
        self.last_collectives = dict(self.dp.counts)
        self.last_p2p = list(self.dp.p2p)
        if self.trace_steps:
            self._trace_step(i, off, phase, first, t0, t1)
        return new_state, metrics

    def _trace_step(self, i: int, off: int, phase: PhaseSpec, first: bool,
                    t0: float, t1: float) -> None:
        """The step's spans, named and tagged as JAX's; ``wire_bytes*``
        are the bytes this dispatch's syncs put on each link."""
        tr = self.tracer
        tr.add("phase", f"phase{off}", t0, t1, step=i, phase=off,
               first=first, update=phase.do_update)
        coll = self._coll_of_step[off]
        wb_p, wb_s = self._wire_count
        tr.add("collective-group", f"collectives@{off}", t0, t1, step=i,
               phase=off, primary=coll["primary"],
               secondary=coll["secondary"], wire_bytes=wb_p + wb_s,
               wire_bytes_primary=wb_p, wire_bytes_secondary=wb_s,
               precision=self._precision_name())
        if phase.do_update:
            tr.instant("update-apply", f"update-k{phase.update_k}", t=t1,
                       step=i, phase=off, k=phase.update_k,
                       source=phase.update_source)
        if self._reuse_of_step[off]:
            tr.instant("gather-skip", "gather-skip", t=t0, step=i, phase=off)

    def _count_wire(self, phase: PhaseSpec, b: int, x: torch.Tensor) -> None:
        """Add one sync of bucket ``b``'s buffer ``x`` to this step's
        bytes on its link."""
        self._wire_count[bool(phase.secondary[b])] += wire_bytes(
            self.layout.wire(b), x.numel())

    def _loss_and_grads(self, params, gbuf, batch):
        """Forward and backward on ``params``: full flat buffers at the
        leaf dtype, or a ``ParamStream`` that gathers them as the forward
        first touches them.  f32 gradients accumulate straight into
        ``gbuf``, others into a scratch buffer of their dtype that is
        promoted into ``gbuf`` after the backward.  The scratch is freed
        before the syncs and the update: held across steps it would raise
        the peak by its size and save no pass, as it has to be zeroed for
        the next backward either way."""
        if self._leaf_dtype == torch.float32:
            gdst = gbuf
        else:
            gdst = [torch.zeros((n,), dtype=self._leaf_dtype,
                                device=self.device)
                    for n in self.layout.buf_sizes]
        if isinstance(params, ParamStream):
            tree = lazy_param_tree(self._structure, self.layout,
                                   params.get_full, gdst)
        else:
            tree = tree_unflatten(self._structure,
                                  _grad_leaves(self.layout, params, gdst))
        loss, parts = loss_fn(
            tree, self.cfg, batch, loss_chunk=self.loss_chunk,
            attn_impl=self.attn_impl, scan_impl=self.scan_impl, tp=self.tp)
        if isinstance(params, ParamStream):
            params.complete()        # the untouched buckets, for the cache
        loss.backward()
        del tree
        if gdst is not gbuf:
            for g, lo in zip(gbuf, gdst):
                g.copy_(lo)
        return loss, parts

    def _step_replicated(self, phase: PhaseSpec, state: TrainState, batch,
                         k: int):
        """One phase of the replicated flat engine; its update divides the
        generation it applies by ``k`` steps (the phase's ``update_k`` but
        after a hand-over)."""
        layout = self.layout
        n_dp = self.dp.n_dp
        # differentiate w.r.t. the params at the leaf dtype
        src = [cast_compute(p, self._leaf_dtype) for p in state["pbuf"]]
        loss, parts = self._loss_and_grads(src, state["gbuf"], batch)
        del src

        def sync(x: torch.Tensor, b: int) -> torch.Tensor:
            self._count_wire(phase, b, x)
            coll = self.dp.secondary if phase.secondary[b] else self.dp.primary
            return _wire_sync(x, layout.wire(b), coll, self.quantize_impl)

        g_flat = list(state["gbuf"])
        cur_synced_in = list(state["cur"])
        gen, new_fut, cur_synced = _route_and_sync(
            phase, g_flat, cur_synced_in, list(state["fut"]), sync)
        spare = None if phase.rotate else g_flat   # added into fut already

        if phase.do_update:
            src = cur_synced if phase.update_source == "cur" else gen
            zero_grads = (phase.update_source == "new") or (gen is None)
            apply_bucket_updates(
                self.opt_spec, self.segments, state["pbuf"], src,
                state["opt"], grad_scale=1.0 / (n_dp * k),
                zero_grads=zero_grads, impl=self.update_impl,
                master_dtype=self.master_dtype,
                quantize_impl=self.quantize_impl,
                model_norm=self._model_norm)
            if phase.update_source == "cur" and gen is not None:
                new_cur, dead = gen, cur_synced
            elif phase.update_source == "cur":       # src zeroed in place
                new_cur, dead = cur_synced, spare
            else:                                    # gen zeroed in place
                new_cur, dead = gen, cur_synced
        elif phase.rotate:
            new_cur, dead = gen, cur_synced
        else:
            new_cur, dead = cur_synced, spare
        # the generation this phase retired becomes the next gradient buffer
        for d in dead:
            d.zero_()
        return {
            "pbuf": state["pbuf"],
            "opt": state["opt"],
            "cur": tuple(new_cur),
            "fut": tuple(new_fut),
            "gbuf": tuple(dead),
        }, loss, parts

    def _step_tree(self, phase: PhaseSpec, state: TrainState, batch,
                   k: int):
        """One phase of the tree-state engine (``_deft_body_fused``): the
        gradient tree from ``autograd.grad`` (zeros for a leaf the loss
        never reads, as ``jax.grad`` gives it) flattened into fresh f32
        bucket buffers, the flat engine's routing and syncs on them, and
        an update through the merged generation's leaf views, divided by
        ``k`` steps as the flat engines' are.  The generation that dies is
        dropped, or zeroed in place where it stays ``cur``."""
        layout = self.layout
        params = tree_map(lambda p: p.detach().requires_grad_(True),
                          state["params"])
        leaves = tree_leaves(params)
        loss, parts = loss_fn(params, self.cfg, batch,
                              loss_chunk=self.loss_chunk,
                              attn_impl=self.attn_impl,
                              scan_impl=self.scan_impl)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        del params, leaves
        g_flat = flatten_buckets(layout, grads)
        del grads

        def sync(x: torch.Tensor, b: int) -> torch.Tensor:
            self._count_wire(phase, b, x)
            return (self.dp.secondary if phase.secondary[b]
                    else self.dp.primary)(x)

        gen, new_fut, cur_synced = _route_and_sync(
            phase, g_flat, list(state["cur"]), list(state["fut"]), sync)
        params, opt = state["params"], state["opt"]
        if phase.do_update:
            src = cur_synced if phase.update_source == "cur" else gen
            params, opt = apply_updates_(
                self.opt_spec, params,
                tree_unflatten(self._structure,
                               unflatten_buckets(layout, src)),
                opt, grad_scale=1.0 / (self.dp.n_dp * k))
            if phase.update_source == "cur" and gen is not None:
                new_cur = gen
            else:
                new_cur = [c.zero_() for c in cur_synced]
        elif phase.rotate:
            new_cur = gen
        else:
            new_cur = cur_synced
        return {"params": params, "opt": opt, "cur": tuple(new_cur),
                "fut": tuple(new_fut)}, loss, parts

    def _step_sharded(self, off: int, phase: PhaseSpec, state: TrainState,
                      batch, k: int):
        """One phase of the sharded flat engine (``_deft_body_flat_rs``),
        on the same three full buffers per bucket as the replicated
        engine: the gradient buffer, ``cur`` and ``fut``.  The param
        gathers run as a burst before the forward, or streamed into it
        with ``decoupled``.  A synced generation that outlives the phase
        is all-gathered back into its own buffer; one the update consumes
        stays a span, and its full buffer is zeroed after the update (the
        update reads spans, so the zeroing cannot ride its launches).  A
        secondary bucket's reduce-scatter and trailing all-gather, and a
        param gather the AG plan put on the secondary link, run along the
        ring chain when one is set; the pod all-reduce stays on its own
        group.  The update divides by ``k``, as the replicated body's."""
        layout, dp = self.layout, self.dp
        nb, rank = layout.n_buckets, dp.rank
        spans = layout.shard_sizes
        reuse = self._reuse[off] or (False,) * nb
        ag_links = self._ag_links[off] or (False,) * nb
        on_chain = [self.secondary_chain is not None and phase.secondary[b]
                    for b in range(nb)]
        cache = state.get("pgather")

        def start(b: int) -> Callable[[], torch.Tensor]:
            """Issue bucket ``b``'s param gather (asynchronous unless it
            runs along the chain)."""
            out = (cache[b] if cache is not None else torch.empty(
                (layout.buf_sizes[b],), dtype=self._leaf_dtype,
                device=self.device))

            def gather(x, o=None):
                if self.decoupled and not ag_links[b]:
                    return dp.all_gather(x, o, "param_gather", async_op=True)
                return dp.all_gather(x, o, "param_gather", ag_links[b]), None
            return _wire_gather_start(state["pbuf"][b], layout.wire(b),
                                      gather, out, self.quantize_impl)

        if self.decoupled:
            params = ParamStream(
                start, [cache[b] if reuse[b] else None for b in range(nb)],
                chained=ag_links, order=self._touch_order[off])
        else:
            params = [cache[b] if reuse[b] else start(b)()
                      for b in range(nb)]
        loss, parts = self._loss_and_grads(params, state["gbuf"], batch)
        if self.decoupled:
            if self._touch_order[off] is None:
                self._touch_order[off] = tuple(params.touched)
            self.last_stream = {
                "touched": tuple(params.touched),
                "issued": tuple(params.issued),
                "issued_at_first_touch": params.issued_at_first_touch}
        del params

        def sync(x: torch.Tensor, b: int) -> torch.Tensor:
            self._count_wire(phase, b, x)
            return _wire_reduce_scatter(
                x, layout.wire(b),
                lambda v: dp.reduce_scatter(v, on_chain[b]),
                self.quantize_impl)

        consumed_new = phase.do_update and phase.update_source == "new"
        consumed_cur = phase.do_update and phase.update_source == "cur"
        g_flat, cur, fut = (list(state[k]) for k in ("gbuf", "cur", "fut"))
        gen_sh: List[Optional[torch.Tensor]] = [None] * nb
        cur_sh: List[Optional[torch.Tensor]] = [None] * nb
        if phase.rotate:
            # the fresh generation merges with the future accumulator
            gen = [g.add_(f) for g, f in zip(g_flat, fut)]
            for b in range(nb):
                if phase.route_new[b] != "sync":
                    continue
                # a span is kept only where the update reads it
                if consumed_new:
                    gen_sh[b] = sync(gen[b], b)
                else:
                    # the trailing all-gather takes its reduce-scatter's link
                    dp.all_gather(sync(gen[b], b), gen[b],
                                  chained=on_chain[b])
            new_fut = [f.zero_() for f in fut]
        else:
            gen = None
            new_fut = [f.add_(g) for f, g in zip(fut, g_flat)]
        for b in range(nb):
            if not phase.sync_cur[b]:
                continue
            if consumed_cur:
                cur_sh[b] = sync(cur[b], b)
            else:
                dp.all_gather(sync(cur[b], b), cur[b], chained=on_chain[b])

        if phase.do_update:
            src, src_sh = (cur, cur_sh) if consumed_cur else (gen, gen_sh)
            # the merged gradient's span: the fresh reduce-scatter where
            # this phase synced the bucket, else this rank's span of the
            # stored (already summed) generation
            src_sh = [y if y is not None
                      else src[b][rank * spans[b]:(rank + 1) * spans[b]]
                      for b, y in enumerate(src_sh)]
            apply_bucket_updates(
                self.opt_spec, self.segments, state["pbuf"], src_sh,
                state["opt"], grad_scale=1.0 / (dp.n_dp * k),
                impl=self.update_impl, shard_id=rank,
                norm_psum=dp.norm if self.opt_spec.grad_clip else None,
                master_dtype=self.master_dtype,
                quantize_impl=self.quantize_impl,
                model_norm=self._model_norm)
            del src_sh
            if consumed_cur and gen is not None:
                new_cur, dead = gen, cur
            elif consumed_cur:
                new_cur, dead = cur, g_flat
            else:
                new_cur, dead = gen, cur
            if not (consumed_cur and gen is not None):
                for c in new_cur:          # the consumed generation
                    c.zero_()
        elif phase.rotate:
            new_cur, dead = gen, cur
        else:
            new_cur, dead = cur, g_flat
        del gen_sh, cur_sh
        for d in dead:
            d.zero_()
        new_state = {
            "pbuf": state["pbuf"],
            "opt": state["opt"],
            "cur": tuple(new_cur),
            "fut": tuple(new_fut),
            "gbuf": tuple(dead),
        }
        if cache is not None:
            new_state["pgather"] = cache
        return new_state, loss, parts

    # ---- reporting ---------------------------------------------------------
    def collectives_per_phase(self) -> List[Dict[str, int]]:
        kw = dict(outer=self.dp.outer is not None,
                  chain=self.secondary_chain is not None)
        if self.fsdp:
            return [phase_collectives_sharded(
                p, self.layout, self._reuse[t], bool(self.opt_spec.grad_clip),
                ag_links=self._ag_links[t], **kw)
                for t, p in enumerate(self.schedule.phases)]
        return [phase_collectives(p, self.layout, n_data=self.dp.size, **kw)
                for p in self.schedule.phases]

    def _precision_name(self) -> str:
        return (self.layout.precision.describe()
                if self.layout.precision is not None else "f32")

    def stats(self) -> Dict[str, Any]:
        coll = self.collectives_per_phase()
        entries = list(self._entries.values())
        n = sum(s.dispatches for s in entries)
        total = sum(s.dispatch_s for s in entries)
        return {
            "period": self.period,
            "unique_phases": self.n_unique_phases,
            "cached_phases": self.n_cached_phases,
            "updates_per_period": self.schedule.updates_per_period,
            "n_buckets": self.layout.n_buckets,
            "n_leaves": self.layout.n_leaves,
            "dp": self.dp.n_dp,
            "pod": self.dp.n_outer,
            "model": 1 if self.tp is None else self.tp.size,
            "flat_state": self.flat_state,
            "sharded_state": self.fsdp,
            "update_impl": (
                (self.update_impl or ("cuda" if self.device.type == "cuda"
                                      else "plain"))
                if self.flat_state else "per-leaf"),
            "decoupled": self.decoupled,
            "secondary_chain": self.secondary_chain,
            "shards": self.layout.shards,
            "gather_skip": self.gather_skip,
            "compute_dtype": str(self.compute_dtype or torch.float32
                                 ).replace("torch.", ""),
            "wire_precision": self._precision_name(),
            "master_dtype": self.master_dtype,
            "planned_wire_bytes_per_cycle": sum(self.wire_bytes_per_phase),
            "steps_dispatched": n,
            "dispatch_s_total": total,
            # host dispatch rate (the card may still be running)
            "steps_per_s": n / total if total > 0 else 0.0,
            "replans": self.replans,
            "hot_swaps": self.hot_swaps,
            "layout_swaps": self.layout_swaps,
            "swap_failures": self.swap_failures,
            "last_swap_error": self.last_swap_error,
            "swap_log": self.swap_log,
            "trace": self.tracer.stats(),
            "collectives_per_phase": coll,
            "max_collectives_in_a_phase": max(
                (sum(v for k, v in c.items()
                     if k not in ("metrics", "chained", "chain_rounds"))
                 for c in coll), default=0),
            "phases": [dataclasses.asdict(s) for s in entries],
        }


# ---------------------------------------------------------------------------
# DDP baseline: every gradient leaf all-reduced, update every step
# ---------------------------------------------------------------------------
def init_ddp_state(cfg: ArchConfig, opt_spec: OptimizerSpec, *, seed: int = 0,
                   device="cuda", params=None) -> TrainState:
    if params is None:
        params = init_params(cfg, seed=seed, device=device)
    return {"params": params, "opt": init_opt_state(opt_spec, params)}


def make_ddp_step(cfg: ArchConfig, opt_spec: OptimizerSpec, *, group=None,
                  loss_chunk: int = 0, attn_impl: Optional[str] = None,
                  scan_impl: Optional[str] = None,
                  microbatch: int = 0, mesh: Any = None) -> Callable:
    """DDP baseline step ``(state, batch) -> (state, metrics)``: one
    all-reduce per gradient leaf, the per-leaf optimizer every step
    (``train/steps.py::ddp_train_step``; ``microbatch = M > 1`` runs the
    batch as M sequential micro-batches).  Under a ``mesh`` the
    all-reduces run over its ('pod', 'data') group, and at model > 1 the
    state holds this rank's shards (``sharding.tp.shard_params``): the
    step runs the model tensor-parallel and each gradient stays this
    rank's shard, as JAX's ``_anchor_grad_shardings`` keeps it."""
    from repro_torch.train.steps import ddp_train_step

    tp = ModelParallel.of(mesh)
    if mesh is not None:
        if group is not None:
            raise ValueError("make_ddp_step takes a mesh or a group, not "
                             "both")
        group = mesh.dp_group
    model = {} if tp is None else dict(tp=tp, norm=functools.partial(
        global_norm, mp=tp, split=split_leaves(
            model_specs(init_params(cfg, device="meta"), mesh))))
    return functools.partial(
        ddp_train_step, cfg=cfg, opt_spec=opt_spec, dp=DataParallel(group),
        loss_chunk=loss_chunk, attn_impl=attn_impl, scan_impl=scan_impl,
        microbatch=microbatch, **model)
