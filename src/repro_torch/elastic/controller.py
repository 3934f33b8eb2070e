"""Elastic replanning: price a proposed mesh, gate it, choose the engine.

On a detected fault the coordinator asks this controller for an
:class:`ElasticPlan`: "the job now has ``n_shards`` data-parallel shards
— what schedule (and which engine) should it run?".  The answer reuses
the adaptive stack end-to-end:

* a :class:`~repro_torch.train.bucketing.LeafTimeModel` **per candidate mesh
  width** (``model_for(n)``) re-prices every bucket under the surviving
  hardware — the ring allreduce factor changes with ``n`` and the
  per-device batch grows as the global batch stays constant;
* the current partition (and, optionally, a
  :class:`~repro_torch.adapt.repartition.Repartitioner` grid over the new
  width) competes through
  :meth:`repro_torch.core.deft.Planner.plan` (candidate grid), every candidate
  **Preserver-gated** exactly like an adaptive repartition;
* cumulative calibrated drift scales (:meth:`set_calibration`) carry
  over from the adaptive controller, so a mesh change planned mid-drift
  prices candidates at the world as measured, not as modeled.

The degradation ladder lives here too (DESIGN.md §10): ``n_shards >=
min_sharded_shards`` keeps the sharded flat engine (scale-down /
scale-up), smaller-but-positive falls back to the replicated flat engine
(``sharded=False`` — a 1-shard ZeRO layout would shard nothing and the
replicated engine skips the gather machinery entirely), and ``n_shards
<= 0`` yields ``checkpoint-halt`` (nothing left to run on — emergency
checkpoint + clean resume is the only move).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.bucket import BucketTimes
from repro_torch.core.deft import Planner, PlanRequest
from repro_torch.core.preserver import PreserverVerdict, WalkParams
from repro_torch.core.scheduler import DeftSchedule, SchedulerConfig
from repro_torch.train.bucketing import LeafTimeModel


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Elastic-plan knobs (DESIGN.md §10)."""

    # below this many surviving shards the sharded flat engine degrades
    # to the replicated flat engine
    min_sharded_shards: int = 2
    # Preserver feedback loop (mirrors AdaptConfig)
    eps: float = 0.01
    max_retries: int = 10
    capacity_growth: float = 1.2
    # survival moves get no switch hysteresis: the old mesh is GONE, so
    # "keep the current plan" is not on the table (contrast
    # RepartitionConfig.min_gain for voluntary repartitions)
    min_gain: float = 0.0
    # optional repartition grid per candidate mesh (empty = keep the
    # installed partition, only re-solve the schedule)
    repartition_factors: Tuple[float, ...] = ()
    base_partition_elems: int = 0


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """One gated mesh-change decision, executable by the coordinator."""

    step: int
    trigger: str          # 'dead' | 'straggler' | 'preemption' | 'scale-up'
    action: str           # 'scale-down' | 'scale-up' |
    #                     # 'fallback-replicated' | 'checkpoint-halt'
    n_shards: int         # surviving data-parallel width (0 = none)
    sharded: bool         # engine: sharded flat (True) or replicated flat
    bucket_of: Tuple[int, ...] = ()
    n_buckets: int = 0
    schedule: Optional[DeftSchedule] = None
    scheduler_cfg: Optional[SchedulerConfig] = None
    verdict: Optional[PreserverVerdict] = None
    times: Optional[BucketTimes] = None
    candidate_solves: Tuple = ()
    plan_s: float = 0.0

    def describe(self) -> str:
        if self.action == "checkpoint-halt":
            return (f"step {self.step:5d}  {self.trigger:<10s} -> "
                    f"checkpoint-halt (no survivors)")
        return (
            f"step {self.step:5d}  {self.trigger:<10s} -> {self.action} "
            f"to {self.n_shards} shard(s) "
            f"[{'sharded' if self.sharded else 'replicated'} engine]  "
            f"period={self.schedule.period} "
            f"k-seq={self.schedule.batch_size_sequence}  "
            f"preserver ratio={self.verdict.ratio:.4f} "
            f"ok={self.verdict.ok}  ({self.plan_s * 1e3:.0f} ms)"
        )


class ElasticController:
    """Owns the installed partition + walk and prices mesh changes.

    ``model_for(n)`` returns the :class:`LeafTimeModel` of this job at
    data-parallel width ``n`` (the coordinator builds it from the arch
    config + hardware model; memoized here — fault handling must not
    re-derive timing atoms on every proposal).
    """

    def __init__(
        self,
        model_for: Callable[[int], LeafTimeModel],
        bucket_of: Tuple[int, ...],
        n_buckets: int,
        *,
        walk: Optional[WalkParams] = None,
        scheduler_cfg: Optional[SchedulerConfig] = None,
        cfg: Optional[ElasticConfig] = None,
    ):
        self.cfg = cfg or ElasticConfig()
        self._model_for = model_for
        self._models: Dict[int, LeafTimeModel] = {}
        self.bucket_of = tuple(bucket_of)
        self.n_buckets = n_buckets
        self.walk = walk or WalkParams(
            s0=4.0, eta=0.01, mu=1.0, sigma=40.0, batch=256
        )
        self.scheduler_cfg = scheduler_cfg or SchedulerConfig()
        # all repack solves route through the unified Planner facade
        self.planner = Planner()
        self._comp_scale = 1.0
        self._comm_scale = 1.0
        self.plans: list = []

    # ---- calibration hand-off -------------------------------------------
    def set_calibration(self, comp_scale: float, comm_scale: float) -> None:
        """Adopt the adaptive controller's cumulative calibrated drift so
        survival plans are priced at measured, not modeled, hardware."""
        self._comp_scale = comp_scale
        self._comm_scale = comm_scale

    def _model(self, n_shards: int) -> LeafTimeModel:
        if n_shards not in self._models:
            self._models[n_shards] = self._model_for(n_shards)
        return self._models[n_shards]

    # ---- planning --------------------------------------------------------
    def propose(self, step: int, n_shards: int, trigger: str) -> ElasticPlan:
        """Plan the move to ``n_shards`` surviving shards.  Always
        returns a plan — worst case ``checkpoint-halt``.  The schedule
        is Preserver-gated through the capacity feedback retries; like
        the capacity feedback loop, an exhausted retry budget yields the
        best-effort schedule with ``verdict.ok=False`` recorded."""
        t0 = time.perf_counter()
        if n_shards <= 0:
            plan = ElasticPlan(
                step=step, trigger=trigger, action="checkpoint-halt",
                n_shards=0, sharded=False,
            )
            self.plans.append(plan)
            return plan
        sharded = n_shards >= self.cfg.min_sharded_shards
        model = self._model(n_shards)
        pairs = [(
            "current",
            model.bucket_times(
                self.bucket_of, self.n_buckets,
                comp_scale=self._comp_scale, comm_scale=self._comm_scale,
            ),
        )]
        cands = {"current": (self.bucket_of, self.n_buckets)}
        if self.cfg.repartition_factors and self.cfg.base_partition_elems:
            from repro_torch.adapt.repartition import (
                RepartitionConfig,
                Repartitioner,
            )

            rp = Repartitioner(model, RepartitionConfig(
                base_partition_elems=self.cfg.base_partition_elems,
                factors=self.cfg.repartition_factors,
                min_gain=self.cfg.min_gain,
            ))
            for c in rp.candidates(
                self.bucket_of, self.n_buckets,
                comp_scale=self._comp_scale, comm_scale=self._comm_scale,
            ):
                if c.tag == "current":
                    continue
                cands[c.tag] = (c.bucket_of, c.n_buckets)
                pairs.append((c.tag, rp.times_for(
                    c,
                    comp_scale=self._comp_scale,
                    comm_scale=self._comm_scale,
                )))
        res = self.planner.plan(PlanRequest(
            candidates=tuple(pairs),
            walk=self.walk,
            baseline_tag="current",
            min_gain=self.cfg.min_gain,
            heterogeneous=self.scheduler_cfg.heterogeneous,
            mu=self.scheduler_cfg.mu,
            eps=self.cfg.eps,
            max_retries=self.cfg.max_retries,
            capacity_growth=self.cfg.capacity_growth,
        ))
        solves = res.candidates
        best = next(s for s in solves if s.tag == res.winner_tag)
        bucket_of, n_buckets = cands[best.tag]
        if trigger == "scale-up":
            action = "scale-up"
        elif sharded:
            action = "scale-down"
        else:
            action = "fallback-replicated"
        plan = ElasticPlan(
            step=step, trigger=trigger, action=action,
            n_shards=n_shards, sharded=sharded,
            bucket_of=tuple(bucket_of), n_buckets=n_buckets,
            schedule=best.schedule, scheduler_cfg=best.scheduler_cfg,
            verdict=best.verdict, times=best.times,
            candidate_solves=solves,
            plan_s=time.perf_counter() - t0,
        )
        self.plans.append(plan)
        return plan

    def adopt(self, plan: ElasticPlan) -> None:
        """The coordinator executed ``plan`` — its partition becomes the
        installed one future proposals price 'current' against."""
        if plan.action == "checkpoint-halt":
            return
        self.bucket_of = tuple(plan.bucket_of)
        self.n_buckets = plan.n_buckets
        self.scheduler_cfg = plan.scheduler_cfg
