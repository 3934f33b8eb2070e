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

A checkpoint holds JAX's tree form of the state (``state_to_tree``):
layout-free param and moment trees, the ``cur``/``fut`` accumulators as
``(accum_devices, n)`` stacks of every DP rank's buffer, and the gather
cache; ``tree_to_state`` inverts it, through a ``LayoutTransition`` when
the checkpoint's layout differs, and ``reset_cycle`` resumes the schedule
at the saved cycle position.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
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
from repro_torch.optim.optimizers import OptimizerSpec, apply_updates, init_opt_state
from repro_torch.train.bucketing import (
    BucketLayout,
    build_layout_transition,
    flatten_bucket,
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
    appended to ``p2p``."""

    REPLICATED = ("primary", "secondary", "metrics")
    SHARDED = ("param_gather", "reduce_scatter", "all_gather", "norm",
               "metrics")

    def __init__(self, group=None, keys: Tuple[str, ...] = REPLICATED, *,
                 outer=None, chain: Optional[Tuple[int, ...]] = None):
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
        if outer is not None and self.n_dp != dist.get_world_size():
            raise ValueError(
                f"a {self.n_outer} x {self.size} pod x data layout does not "
                f"cover the {dist.get_world_size()} ranks of the world")
        # the group of a joint sum over every DP axis
        self.joint = group if outer is None else None
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
        """The sum over the 'data' ranks of a squared-norm scalar (in
        place): the pod replicas hold the same spans."""
        dist.all_reduce(x.reshape(1), group=self.group)
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
    """Collectives one phase issues, by construction: one primary sync per
    primary-synced bucket, one secondary sync per secondary-synced bucket,
    plus the single metrics all-reduce.  Over ``n_data`` 'data' ranks with
    an ``outer`` 'pod' group, a secondary sync whose buffer (``layout``)
    splits over the ranks adds one all-reduce over 'pod'; with a ``chain``
    each secondary sync is chained, in ``2 (n_data - 1)`` rounds."""
    n = len(phase.route_new)
    synced = [
        (phase.route_new[b] == "sync" and phase.rotate) or phase.sync_cur[b]
        for b in range(n)
    ]
    primary = sum(1 for b in range(n) if synced[b] and not phase.secondary[b])
    secondary = [b for b in range(n) if synced[b] and phase.secondary[b]]
    out = {"primary": primary, "secondary": len(secondary), "metrics": 1}
    if outer:
        out["outer"] = sum(1 for b in secondary
                           if layout.buf_sizes[b] % n_data == 0
                           and layout.buf_sizes[b] >= n_data)
    if chain:
        out["chained"] = len(secondary)
        out["chain_rounds"] = 2 * (n_data - 1) * len(secondary)
    return out


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
    """Per-unique-phase dispatch statistics (host clock, enqueue time on
    the card)."""

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
    the 'pod' group of a ``pod x data`` layout (``launch.train.pod_groups``).
    ``secondary_chain`` (a permutation of the 'data' ranks,
    ``launch.mesh.ring_chain``) routes the secondary link's collectives
    along that chain, and ``ag_plan`` (an ``AgStreamPlan``) the sharded
    engine's param gathers it puts on link 1 (without a chain the plan
    routes nothing, as in JAX)."""

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
                 ag_plan: Any = None):
        if gather_skip and not fsdp:
            raise ValueError(
                "gather_skip only applies to the sharded flat engine "
                "(fsdp=True): the replicated engine never all-gathers params")
        if decoupled and not fsdp:
            raise ValueError(
                "decoupled AG streaming only applies to the sharded flat "
                "engine (fsdp=True): the replicated engine has no per-bucket "
                "param all-gather to stream (DESIGN.md §12)")
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
        self.schedule = schedule
        self.layout = layout
        self.device = torch.device(device)
        self.fsdp = bool(fsdp)
        self.decoupled = bool(decoupled)
        self.secondary_chain = chain
        self.dp = DataParallel(group, DataParallel.SHARDED if self.fsdp
                               else DataParallel.REPLICATED,
                               outer=outer_group, chain=chain)
        if chain is not None and len(chain) != self.dp.size:
            raise ValueError(
                f"secondary_chain covers {len(chain)} positions but the "
                f"'data' axis is {self.dp.size}-way — build it with "
                f"launch.mesh.ring_chain({self.dp.size}, link)")
        if self.fsdp and layout.shards != self.dp.size:
            # the layout's own check keeps every span a multiple of 128
            # lanes, so the int8 wire's blockwise grid tiles each span
            raise ValueError(
                f"sharded flat engine: BucketLayout was built with "
                f"shard_count={layout.shards} but the 'data' group has "
                f"{self.dp.size} ranks — build the layout with "
                f"build_bucket_layout(..., shard_count={self.dp.size})")
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
        self._structure = init_params(cfg, device="meta")
        shapes = tuple(tuple(l.shape) for l in tree_leaves(self._structure))
        if shapes != layout.shapes:
            raise ValueError("BucketLayout does not match this config's "
                             "parameter tree")
        self.segments = build_segments(layout, opt_spec)
        masks = _gather_reuse_masks(schedule)
        self.gather_skip = bool(
            gather_skip if gather_skip is not None
            else self.fsdp and any(any(m) for m in masks))
        # per cycle position, the mask (None with the skip off)
        self._reuse = masks if self.gather_skip else [None] * schedule.period
        self._ag_plan = ag_plan
        self._ag_links = self._ag_link_masks(schedule)
        # per cycle position, the buckets' first-touch order of its first
        # streamed dispatch (the order the gathers are issued ahead in)
        self._touch_order: List[Optional[Tuple[int, ...]]] = \
            [None] * schedule.period
        self.last_stream: Optional[Dict[str, Any]] = None
        unique: Dict[PhaseSpec, int] = {}
        self.phase_of_step = tuple(unique.setdefault(ph, len(unique))
                                   for ph in schedule.phases)
        self._stats = [PhaseStats() for _ in unique]
        self.last_collectives: Dict[str, int] = dict(self.dp.counts)
        self.last_p2p: List[Tuple[Tuple[int, int], ...]] = []
        self._cycle_base = 0               # step at which the cycle restarts

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

    @property
    def period(self) -> int:
        return self.schedule.period

    @property
    def n_unique_phases(self) -> int:
        return len(self._stats)

    @property
    def accum_devices(self) -> int:
        """Rows of a checkpoint's accumulator stacks: every DP rank's."""
        return self.dp.n_dp

    def reset_cycle(self, step: int) -> None:
        """Restart the schedule cycle at ``step``: a restored run that
        cannot continue mid-cycle begins a fresh cycle there (position 0,
        which always gathers)."""
        self._cycle_base = step

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
        ``fut`` and the gradient buffers are full length on every rank."""
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
            state["pgather"] = self._init_pgather()
        return state

    def _master_torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.master_dtype == "bf16sr" \
            else torch.float32

    def _init_pgather(self) -> Tuple[torch.Tensor, ...]:
        """Cold gather cache: full zero buffers of the forward's dtype.
        Position 0 of a cycle always gathers into them before any phase
        reads them; the engine gathers into these buffers in place, so
        the cache is the gathered tensors themselves."""
        return tuple(torch.zeros((n,), dtype=self._leaf_dtype,
                                 device=self.device)
                     for n in self.layout.buf_sizes)

    def init_state(self, seed: int = 0,
                   dtype: torch.dtype = torch.float32) -> TrainState:
        """Fresh state from params drawn at ``dtype`` (the compute dtype
        of a mixed-precision run: the init rounding), promoted into the
        master."""
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
        collective, which every rank must call."""
        pbuf = state["pbuf"]
        if self.fsdp:
            pbuf = [self.dp.all_gather(p) for p in pbuf]
        return tree_unflatten(self._structure,
                              unflatten_buckets(self.layout, pbuf))

    # ---- checkpoint form -----------------------------------------------
    def _to_writer(self, buf: torch.Tensor, group) -> Optional[torch.Tensor]:
        """Every rank of ``group``'s ``buf`` (one size on all of them) as
        the rows of a host stack on global rank 0, the rank that writes
        checkpoints; None elsewhere.  The rows arrive one rank at a time
        through one device buffer of ``buf``'s size, so no device holds
        more than one extra ``buf``; the other ranks send theirs (point to
        point, uncounted), and a group without rank 0 moves nothing."""
        me, size = dist.get_rank(), dist.get_world_size(group)
        ranks = [r if group is None else dist.get_global_rank(group, r)
                 for r in range(size)]
        if 0 not in ranks:
            return None
        if me != 0:
            dist.send(buf, dst=0, group=group)
            return None
        host = torch.empty((size, buf.numel()), dtype=buf.dtype)
        tmp = torch.empty_like(buf) if size > 1 else None
        for r, g in enumerate(ranks):
            if g == 0:
                host[r].copy_(buf)
            else:
                dist.recv(tmp, src=g, group=group)
                host[r].copy_(tmp)
        return host

    def state_to_tree(self, state: TrainState) -> Optional[TrainState]:
        """The JAX package's checkpoint form of a train state, on the host
        of global rank 0 (the rank that writes checkpoints; None on the
        others): ``{params, opt{step, m[, v]}, cur, fut[, pgather]}``.
        Params and moments are layout-free trees (at the master dtype and
        f32); ``cur``/``fut`` are ``(accum_devices, n)`` stacks of every DP
        rank's buffer, row ``r`` the joint ('pod', 'data') rank ``r``, and
        ``pgather`` one full buffer per bucket at the forward's dtype, all
        bound to this runtime's layout.

        Collective: every rank calls it.  Rank 0 receives each bucket (the
        sharded engine's spans, each accumulator row) one rank at a time
        into a device buffer the size of the bucket's span or row, and
        copies it to its host; the others only send.  So each device holds
        at most one span or row more than its state, and only rank 0's
        host holds the tree."""
        layout, dp = self.layout, self.dp
        writer = dist.get_rank() == 0

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
        generation between steps."""
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

        f32 = torch.float32
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
                out["pgather"] = self._init_pgather()
        return out

    def checkpoint_struct(self, src_layout: Optional[BucketLayout] = None,
                          *, with_pgather: Optional[bool] = None
                          ) -> TrainState:
        """Meta tensors shaped as :meth:`state_to_tree`'s output written
        under ``src_layout`` (default: this runtime's layout): the ``like``
        of ``checkpoint.restore``.  ``with_pgather`` says whether the
        checkpoint carries the gather cache; by default only a same-layout
        restore on a gather-skip runtime reads it."""
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

    # ---- one phase ---------------------------------------------------------
    def step(self, i: int, state: TrainState, batch
             ) -> Tuple[TrainState, Dict[str, Any]]:
        off = self.phase_in_cycle(i)
        phase = self.schedule.phases[off]
        t0 = time.perf_counter()
        self.dp.reset()
        if self.fsdp:
            new_state, loss, parts = self._step_sharded(off, phase, state,
                                                        batch)
        else:
            new_state, loss, parts = self._step_replicated(phase, state,
                                                           batch)
        metrics = _fused_metrics(loss, parts, phase, self.dp.n_dp, self.dp)
        st = self._stats[self.phase_of_step[off]]
        st.dispatches += 1
        st.dispatch_s += time.perf_counter() - t0
        self.last_collectives = dict(self.dp.counts)
        self.last_p2p = list(self.dp.p2p)
        return new_state, metrics

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
            attn_impl=self.attn_impl, scan_impl=self.scan_impl)
        if isinstance(params, ParamStream):
            params.complete()        # the untouched buckets, for the cache
        loss.backward()
        del tree
        if gdst is not gbuf:
            for g, lo in zip(gbuf, gdst):
                g.copy_(lo)
        return loss, parts

    def _step_replicated(self, phase: PhaseSpec, state: TrainState, batch):
        layout = self.layout
        n_dp = self.dp.n_dp
        # differentiate w.r.t. the params at the leaf dtype
        src = [cast_compute(p, self._leaf_dtype) for p in state["pbuf"]]
        loss, parts = self._loss_and_grads(src, state["gbuf"], batch)
        del src

        def sync(x: torch.Tensor, b: int) -> torch.Tensor:
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
                state["opt"], grad_scale=1.0 / (n_dp * phase.update_k),
                zero_grads=zero_grads, impl=self.update_impl,
                master_dtype=self.master_dtype,
                quantize_impl=self.quantize_impl)
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

    def _step_sharded(self, off: int, phase: PhaseSpec, state: TrainState,
                      batch):
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
        group."""
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
                state["opt"], grad_scale=1.0 / (dp.n_dp * phase.update_k),
                impl=self.update_impl, shard_id=rank,
                norm_psum=dp.norm if self.opt_spec.grad_clip else None,
                master_dtype=self.master_dtype,
                quantize_impl=self.quantize_impl)
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

    def stats(self) -> Dict[str, Any]:
        coll = self.collectives_per_phase()
        n = sum(s.dispatches for s in self._stats)
        total = sum(s.dispatch_s for s in self._stats)
        return {
            "period": self.period,
            "unique_phases": self.n_unique_phases,
            "updates_per_period": self.schedule.updates_per_period,
            "n_buckets": self.layout.n_buckets,
            "n_leaves": self.layout.n_leaves,
            "dp": self.dp.n_dp,
            "pod": self.dp.n_outer,
            "sharded_state": self.fsdp,
            "decoupled": self.decoupled,
            "secondary_chain": self.secondary_chain,
            "shards": self.layout.shards,
            "gather_skip": self.gather_skip,
            "compute_dtype": str(self.compute_dtype or torch.float32
                                 ).replace("torch.", ""),
            "wire_precision": (self.layout.precision.describe()
                               if self.layout.precision is not None
                               else "f32"),
            "master_dtype": self.master_dtype,
            "steps_dispatched": n,
            "dispatch_s_total": total,
            "collectives_per_phase": coll,
            "max_collectives_in_a_phase": max(
                (sum(v for k, v in c.items()
                     if k not in ("metrics", "chained", "chain_rounds"))
                 for c in coll), default=0),
            "phases": [dataclasses.asdict(s) for s in self._stats],
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
                  scan_impl: Optional[str] = None) -> Callable:
    """DDP baseline step ``(state, batch) -> (state, metrics)``: one
    all-reduce per gradient leaf, the per-leaf optimizer every step."""
    dp = DataParallel(group)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        params = tree_map(lambda p: p.detach().requires_grad_(True),
                          state["params"])
        leaves = tree_leaves(params)
        loss, parts = loss_fn(params, cfg, batch, loss_chunk=loss_chunk,
                              attn_impl=attn_impl, scan_impl=scan_impl)
        grads = torch.autograd.grad(loss, leaves)
        for g in grads:
            dp.primary(g)
        new_params, opt = apply_updates(
            opt_spec, tree_map(lambda p: p.detach(), params),
            tree_unflatten(params, list(grads)), state["opt"],
            grad_scale=1.0 / dp.size)
        keys = sorted(parts)
        stacked = dp.metrics(torch.stack(
            [loss.detach()] + [parts[k].detach() for k in keys])) / dp.size
        metrics = {"loss": stacked[0],
                   **{k: stacked[1 + j] for j, k in enumerate(keys)},
                   "updated": True}
        return {"params": new_params, "opt": opt}, metrics

    return step
