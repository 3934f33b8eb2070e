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

JAX's arrays are immutable and its executables donate the state; the
port updates the buffers in place instead (the same memory footprint:
param, two moments, two generations and one gradient buffer per bucket)
and recycles the consumed generation as the next step's gradient buffer.
There is no AOT cache: phases are deduplicated by ``PhaseSpec`` and each
unique phase keeps its dispatch statistics.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

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
    quantize_dequantize_int8,
    stochastic_round_bf16,
)
from repro_torch.models.model import init_params, loss_fn
from repro_torch.optim.optimizers import OptimizerSpec, apply_updates, init_opt_state
from repro_torch.train.bucketing import (
    BucketLayout,
    flatten_buckets,
    unflatten_buckets,
)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

TrainState = Dict[str, Any]


class DataParallel:
    """The collectives of the replicated engine over one process group,
    with a count of what was issued (reset per step by the runtime)."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError(
                "the DeFT runtime syncs through torch.distributed: initialise "
                "a process group first (launch.train.init_distributed)"
            )
        self.group = group
        self.size = dist.get_world_size(group)
        self.counts = {"primary": 0, "secondary": 0, "metrics": 0}

    def reset(self) -> None:
        self.counts = {k: 0 for k in self.counts}

    def primary(self, x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, group=self.group)
        self.counts["primary"] += 1
        return x

    def secondary(self, x: torch.Tensor) -> torch.Tensor:
        """Reduce-scatter then all-gather (in place); ``all_reduce`` when
        the buffer does not split evenly over the ranks."""
        n = x.numel()
        if n % self.size == 0 and n >= self.size:
            shard = torch.empty(n // self.size, dtype=x.dtype, device=x.device)
            dist.reduce_scatter_tensor(shard, x, group=self.group)
            dist.all_gather_into_tensor(x, shard, group=self.group)
        else:
            dist.all_reduce(x, group=self.group)
        self.counts["secondary"] += 1
        return x

    def metrics(self, x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, group=self.group)
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


def phase_collectives(phase: PhaseSpec) -> Dict[str, int]:
    """Collectives one phase issues, by construction: one primary sync per
    primary-synced bucket, one secondary sync per secondary-synced bucket,
    plus the single metrics all-reduce."""
    n = len(phase.route_new)
    synced = [
        (phase.route_new[b] == "sync" and phase.rotate) or phase.sync_cur[b]
        for b in range(n)
    ]
    primary = sum(1 for b in range(n) if synced[b] and not phase.secondary[b])
    secondary = sum(1 for b in range(n) if synced[b] and phase.secondary[b])
    return {"primary": primary, "secondary": secondary, "metrics": 1}


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
    """Runs one DeFT schedule on the replicated flat-resident engine.

    ``step(i, state, batch)`` runs cycle phase ``i % period`` and returns
    (state, metrics); the state's buffers are updated in place.

    ``compute_dtype`` (None or ``torch.bfloat16``) is the forward/backward
    dtype; ``master_dtype`` ("f32" or "bf16sr", None to take the layout's)
    the resident param dtype; ``attn_impl`` / ``scan_impl`` /
    ``update_impl`` / ``quantize_impl`` = "plain" force the kernels' plain
    versions."""

    def __init__(self, cfg: ArchConfig, opt_spec: OptimizerSpec,
                 schedule: DeftSchedule, layout: BucketLayout, *,
                 device="cuda", group=None, loss_chunk: int = 0,
                 attn_impl: Optional[str] = None,
                 scan_impl: Optional[str] = None,
                 update_impl: Optional[str] = None,
                 quantize_impl: Optional[str] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 master_dtype: Optional[str] = None):
        self.cfg = cfg
        self.opt_spec = opt_spec
        self.schedule = schedule
        self.layout = layout
        self.device = torch.device(device)
        self.dp = DataParallel(group)
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
        self._leaf_dtype = compute_dtype or (
            torch.bfloat16 if self.master_dtype == "bf16sr" else torch.float32)
        self._structure = init_params(cfg, device="meta")
        shapes = tuple(tuple(l.shape) for l in tree_leaves(self._structure))
        if shapes != layout.shapes:
            raise ValueError("BucketLayout does not match this config's "
                             "parameter tree")
        self.segments = build_segments(layout, opt_spec)
        unique: Dict[PhaseSpec, int] = {}
        self.phase_of_step = tuple(unique.setdefault(ph, len(unique))
                                   for ph in schedule.phases)
        self._stats = [PhaseStats() for _ in unique]
        self.last_collectives: Dict[str, int] = dict(self.dp.counts)

    @property
    def period(self) -> int:
        return self.schedule.period

    @property
    def n_unique_phases(self) -> int:
        return len(self._stats)

    # ---- state -----------------------------------------------------------
    def state_from_params(self, params) -> TrainState:
        """Train state whose param buffers hold ``params`` (a tree),
        promoted into the f32 master; a bf16sr master is then rounded
        down bucket by bucket by the stochastic-rounding kernel, with seed
        b + 1 as JAX's ``_round_master``."""
        pbuf = tuple(flatten_buckets(
            self.layout, [p.to(self.device) for p in tree_leaves(params)]))
        if self.master_dtype == "bf16sr":
            pbuf = tuple(stochastic_round_bf16(p, b + 1, impl=self.quantize_impl)
                         for b, p in enumerate(pbuf))
        acc = init_fused_accumulators(self.layout, self.device)
        return {
            "pbuf": pbuf,
            "opt": init_flat_opt_state(self.opt_spec, self.layout.buf_sizes,
                                       self.device),
            "cur": acc["cur"],
            "fut": acc["fut"],
            "gbuf": tuple(torch.zeros((n,), dtype=torch.float32,
                                      device=self.device)
                          for n in self.layout.buf_sizes),
        }

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
        """Parameter tree of views into the param buffers."""
        return tree_unflatten(self._structure,
                              unflatten_buckets(self.layout, state["pbuf"]))

    # ---- one phase ---------------------------------------------------------
    def step(self, i: int, state: TrainState, batch
             ) -> Tuple[TrainState, Dict[str, Any]]:
        off = i % self.period
        phase = self.schedule.phases[off]
        t0 = time.perf_counter()
        layout = self.layout
        n_dp = self.dp.size
        self.dp.reset()

        # differentiate w.r.t. the params at the leaf dtype: f32 gradients
        # accumulate straight into gbuf, others into a scratch buffer of
        # their dtype that is promoted into gbuf after the backward.  The
        # scratch is freed before the syncs and the update: held across
        # steps it would raise the peak by its size and save no pass, as
        # it has to be zeroed for the next backward either way.
        src = [cast_compute(p, self._leaf_dtype) for p in state["pbuf"]]
        if self._leaf_dtype == torch.float32:
            gdst = state["gbuf"]
        else:
            gdst = [torch.zeros((n,), dtype=self._leaf_dtype,
                                device=self.device) for n in layout.buf_sizes]
        leaves = _grad_leaves(layout, src, gdst)
        loss, parts = loss_fn(
            tree_unflatten(self._structure, leaves), self.cfg, batch,
            loss_chunk=self.loss_chunk, attn_impl=self.attn_impl,
            scan_impl=self.scan_impl)
        loss.backward()
        del leaves, src
        if gdst is not state["gbuf"]:
            for g, lo in zip(state["gbuf"], gdst):
                g.copy_(lo)
        del gdst

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

        metrics = _fused_metrics(loss, parts, phase, n_dp, self.dp)
        new_state = {
            "pbuf": state["pbuf"],
            "opt": state["opt"],
            "cur": tuple(new_cur),
            "fut": tuple(new_fut),
            "gbuf": tuple(dead),
        }
        st = self._stats[self.phase_of_step[off]]
        st.dispatches += 1
        st.dispatch_s += time.perf_counter() - t0
        self.last_collectives = dict(self.dp.counts)
        return new_state, metrics

    # ---- reporting ---------------------------------------------------------
    def collectives_per_phase(self) -> List[Dict[str, int]]:
        return [phase_collectives(p) for p in self.schedule.phases]

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
            "dp": self.dp.size,
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
                (c["primary"] + c["secondary"] for c in coll), default=0),
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
