"""Drift detection + Preserver-gated replanning (the online Fig. 7 loop).

The controller sits between :class:`DeftRuntime` and the planner.  Every
step the train loop feeds it (step id, phase-in-cycle, wall seconds,
loss); every ``check_every`` steps — once telemetry is warm — it:

1. **calibrates**: fits (comp_scale, comm_scale) so the simulated
   per-phase durations of the installed plan match the measured EMAs
   (:mod:`repro_torch.adapt.calibrate`);
2. **detects drift**: either fitted scale deviating from 1 beyond
   ``drift_threshold`` (the plan's timing assumptions are wrong), or the
   Preserver verdict flipping when re-checked under *measured*
   ``WalkParams`` fit from the observed loss trace (the plan's
   convergence assumptions are wrong);
3. **replans**: re-runs the Solver + Preserver feedback loop
   (:meth:`repro_torch.core.deft.Planner.plan`) on the calibrated bucket
   times.  The knapsack memo cache (core/knapsack.py) makes consecutive
   replans over a drifting-but-similar profile cheap — the solver
   re-solves mostly cache-hit instances.

A replan yields a :class:`ReplanEvent`; when the new schedule's phases
differ from the installed ones the caller hands it to
``DeftRuntime.prepare_swap`` for background compile + period-boundary
hot-swap.  All of this runs off the hot path: the controller does pure
Python (simulator + DP) work, never touches device state, and a
``cooldown`` keeps it from thrashing while new telemetry accumulates.
"""
from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

from repro_torch.adapt.calibrate import (
    CalibratedProfile,
    calibrate,
    planned_phase_durations,
    scale_times,
)
from repro_torch.adapt.telemetry import Telemetry, TelemetryConfig
from repro_torch.core.bucket import BucketTimes
from repro_torch.core.deft import Planner, PlanRequest
from repro_torch.core.precision import PrecisionPolicy, apply_wire_precision
from repro_torch.core.preserver import (
    PreserverVerdict,
    WalkParams,
    check_schedule,
    estimate_walk_params_from_losses,
)
from repro_torch.core.scheduler import DeftSchedule, SchedulerConfig
from repro_torch.obs.trace import Tracer

if TYPE_CHECKING:   # the controller only duck-types the repartitioner
    from repro_torch.adapt.repartition import PartitionCandidate, Repartitioner


@dataclasses.dataclass(frozen=True)
class AdaptConfig:
    """Control-plane constants (DESIGN.md §7 documents the choices)."""

    # telemetry
    ring_size: int = 256
    ema_alpha: float = 0.25
    warmup_steps: int = 8
    # drift detection
    check_every: int = 8          # steps between calibration passes
    drift_threshold: float = 0.25 # |scale - 1| that triggers a replan
    # what the drift screen + calibration consume (DESIGN.md §11):
    # 'ema'        — per-phase EMA wall times (legacy; smooth, laggy)
    # 'divergence' — the obs layer's latest-sample per-phase durations
    #                (raw predicted-vs-actual divergence; reacts a full
    #                EMA settling time earlier after a step change)
    drift_source: str = "ema"
    cooldown_steps: int = 16      # min steps between replans
    min_loss_samples: int = 12    # before the measured-WalkParams check
    # replanning (mirrors the Planner's feedback-loop defaults)
    eps: float = 0.01
    max_retries: int = 10
    capacity_growth: float = 1.2
    # measured-WalkParams fit inputs
    eta: float = 1e-3             # learning rate fed to the walk fit
    base_batch: int = 256
    # wire precision (DESIGN.md §13).  'f32' keeps precision FROZEN —
    # the default controller never touches the wire (an explicitly
    # installed policy is still re-priced and re-gated each replan).
    # 'auto' opts precision in as an escalation lever: a replan whose
    # calibrated comm_scale reaches ``precision_comm_scale`` (a
    # bandwidth collapse rather than mild drift) walks the downgrade
    # ladder — shedding wire bytes is cheaper than surrendering
    # coverage to a starved link; short of the bar, the installed
    # policy is kept as-is.  'bf16'/'int8' force that uniform wire on
    # every replan (collapse still escalates to the full ladder).
    wire_precision: str = "f32"
    precision_comm_scale: float = 1.5


@dataclasses.dataclass(frozen=True)
class ReplanEvent:
    """One control-plane action, in human-readable terms."""

    step: int
    trigger: str                   # 'timing-drift' | 'preserver-flip'
    profile: CalibratedProfile
    old_coverage_rate: float
    new_coverage_rate: float
    old_period: int
    new_period: int
    old_batch_seq: tuple
    new_batch_seq: tuple
    verdict: PreserverVerdict      # Preserver verdict of the NEW schedule
    schedule: DeftSchedule
    scheduler_cfg: SchedulerConfig
    times: BucketTimes             # calibrated times the replan consumed
    changed: bool                  # new phases differ from installed ones
    replan_s: float                # wall seconds spent solving
    # ---- partition-change replans (repartitioner attached) --------------
    old_n_buckets: int = 0
    new_n_buckets: int = 0
    # the adopted candidate when it differs from the installed partition
    # (None = the replan kept the current partition)
    partition: Optional["PartitionCandidate"] = None
    candidate_solves: Tuple = ()   # CandidateSolve table, input order
    # ---- precision replans (DESIGN.md §13) ------------------------------
    # None = precision planning did not engage (wire stayed at f32)
    old_precision: Optional[PrecisionPolicy] = None
    new_precision: Optional[PrecisionPolicy] = None
    wire_bytes_scale: float = 1.0  # new policy wire bytes / all-f32 bytes

    @property
    def partition_changed(self) -> bool:
        return self.partition is not None

    @property
    def precision_changed(self) -> bool:
        old = self.old_precision.wire if self.old_precision else None
        new = self.new_precision.wire if self.new_precision else None
        return old != new

    @property
    def coverage_delta(self) -> float:
        return self.new_coverage_rate - self.old_coverage_rate

    def describe(self) -> str:
        out = (
            f"step {self.step:5d}  {self.trigger:<14s} "
            f"comp x{self.profile.comp_scale:.2f} "
            f"comm x{self.profile.comm_scale:.2f}  "
            f"CR {self.old_coverage_rate:.2f}->{self.new_coverage_rate:.2f} "
            f"(d{self.coverage_delta:+.2f})  "
            f"period {self.old_period}->{self.new_period}  "
            f"k-seq {self.old_batch_seq}->{self.new_batch_seq}  "
            f"preserver ratio={self.verdict.ratio:.4f} "
            f"ok={self.verdict.ok}  "
            f"{'SWAP' if self.changed else 'no-op'} "
            f"({self.replan_s * 1e3:.0f} ms)"
        )
        if self.partition_changed:
            out += (
                f"  REPARTITION {self.old_n_buckets}->"
                f"{self.new_n_buckets} buckets [{self.partition.tag}]"
            )
        if self.precision_changed:
            old = (
                self.old_precision.describe() if self.old_precision
                else "f32"
            )
            new = (
                self.new_precision.describe() if self.new_precision
                else "f32"
            )
            out += (
                f"  PRECISION {old}->{new} "
                f"(bytes x{self.wire_bytes_scale:.2f})"
            )
        return out


class AdaptiveController:
    """Owns telemetry + the installed plan's planning-time view."""

    def __init__(
        self,
        times: BucketTimes,
        schedule: DeftSchedule,
        scheduler_cfg: SchedulerConfig,
        walk: Optional[WalkParams] = None,
        cfg: Optional[AdaptConfig] = None,
        repartitioner: Optional["Repartitioner"] = None,
        bucket_of: Optional[Sequence[int]] = None,
        tracer: Optional[Tracer] = None,
        precision: Optional[PrecisionPolicy] = None,
    ):
        self.cfg = cfg or AdaptConfig()
        self.tracer = tracer
        self.times = times                   # what the installed plan assumed
        self.schedule = schedule
        self.scheduler_cfg = scheduler_cfg
        # the installed wire-precision policy (None = all-f32); replans
        # that adopt a different one report it on the ReplanEvent so the
        # caller can hot-swap layout.with_precision(...) alongside the
        # schedule
        self.precision = precision
        self.walk = walk or WalkParams(
            s0=4.0, eta=0.01, mu=1.0, sigma=40.0, batch=256
        )
        # all replans route through the unified Planner facade
        self.planner = Planner()
        # ---- optional repartitioning (DESIGN.md §9) ----------------------
        # With a repartitioner attached, every replan ALSO considers a
        # grid of alternative bucket partitions; ``bucket_of`` names the
        # installed one.  ``times`` must come from the repartitioner's
        # LeafTimeModel (same partition, same CR rescale) so candidate
        # times stay commensurable with the calibrated baseline.
        self.repartitioner = repartitioner
        self.bucket_of = tuple(bucket_of) if bucket_of is not None else None
        if repartitioner is not None and self.bucket_of is None:
            raise ValueError(
                "repartitioning needs bucket_of (the installed partition)"
            )
        # cumulative calibrated drift vs the LeafTimeModel's base times —
        # candidate partitions are priced at these scales
        self._cum_comp = 1.0
        self._cum_comm = 1.0
        self.telemetry = Telemetry(
            schedule.period,
            TelemetryConfig(
                ring_size=self.cfg.ring_size,
                ema_alpha=self.cfg.ema_alpha,
                warmup_steps=self.cfg.warmup_steps,
            ),
        )
        self.events: List[ReplanEvent] = []
        self._last_replan_step = -(10**9)
        self._last_check_step = -(10**9)

    # ---- the per-step hook ----------------------------------------------
    def observe(
        self,
        step: int,
        phase: int,
        wall_s: float,
        loss: Optional[float] = None,
        updated: bool = False,
        cold: Optional[bool] = None,
    ) -> Optional[ReplanEvent]:
        """Feed one step's telemetry; returns a ReplanEvent when this step
        triggered a replan (caller decides whether to hot-swap).  ``cold``
        is the runtime's first-dispatch tag (``last_dispatch_first``) —
        see :meth:`Telemetry.record`."""
        self.telemetry.record(step, phase, wall_s, loss, updated, cold=cold)
        if step - self._last_check_step < self.cfg.check_every:
            return None
        if step - self._last_replan_step < self.cfg.cooldown_steps:
            return None
        if not self.telemetry.ready():
            return None
        self._last_check_step = step
        return self._check(step)

    def wire_times(self) -> BucketTimes:
        """The installed plan's on-the-wire timing view: the planning
        baseline re-priced by the installed precision policy.  Measured
        wall times reflect the quantized wire, so the drift screen and
        the calibration fit must compare against THIS, not the f32
        baseline — otherwise an installed bf16 wire reads as a
        permanent comm_scale ~0.5 'drift'."""
        if self.precision is None or self.precision.all_f32:
            return self.times
        return apply_wire_precision(self.times, self.precision)

    # ---- drift detection -------------------------------------------------
    def measured_phase_durations(self) -> List[Optional[float]]:
        """Per-phase durations the drift screen and calibration consume:
        the phase EMAs (``drift_source='ema'``) or the obs layer's
        latest-sample view (``'divergence'`` — no smoothing lag)."""
        if self.cfg.drift_source == "divergence":
            # deferred: obs.attribution imports adapt.calibrate, so a
            # top-level import here would be circular via the packages
            from repro_torch.obs.attribution import latest_phase_durations
            return latest_phase_durations(
                self.telemetry.samples(), self.schedule.period
            )
        return self.telemetry.phase_times()

    def duration_deviation(self) -> float:
        """Cheap steady-state screen: largest relative deviation of a
        phase's measured duration from the planned one.  Only when this
        exceeds the drift threshold is the full 2-D calibration fit worth
        paying for (both are off the hot path; this keeps the common
        nothing-drifted check at ~zero cost)."""
        planned = planned_phase_durations(
            self.wire_times(), self.scheduler_cfg, self.schedule.period
        )
        dev = 0.0
        for p, m in zip(planned, self.measured_phase_durations()):
            if m is not None and p > 1e-12:
                dev = max(dev, abs(m - p) / p)
        return dev

    def _check(self, step: int) -> Optional[ReplanEvent]:
        trigger: Optional[str] = None
        # once a measured walk exists, EVERY replan solves under it —
        # mixing the planned walk into timing replans and the measured
        # walk into flip replans makes consecutive replans oscillate
        # between the two convergence models
        measured_walk = self.measured_walk()
        walk = measured_walk or self.walk
        profile: Optional[CalibratedProfile] = None
        if self.duration_deviation() > self.cfg.drift_threshold:
            profile = calibrate(
                self.wire_times(),
                self.scheduler_cfg,
                self.schedule.period,
                self.measured_phase_durations(),
            )
            if profile.drift > self.cfg.drift_threshold:
                trigger = "timing-drift"
        if trigger is None and measured_walk is not None:
            v = check_schedule(
                self.schedule.batch_size_sequence,
                self.schedule.period,
                measured_walk,
                eps=self.cfg.eps,
            )
            if not v.ok:
                trigger = "preserver-flip"
        if trigger is None:
            return None
        if profile is None:
            profile = calibrate(
                self.wire_times(),
                self.scheduler_cfg,
                self.schedule.period,
                self.measured_phase_durations(),
            )
        return self._replan(step, trigger, profile, walk)

    def measured_walk(self) -> Optional[WalkParams]:
        """WalkParams fit from the observed loss trace (the paper's
        'convergence info' edge of Fig. 7); None until enough samples."""
        losses = self.telemetry.losses()
        if len(losses) < self.cfg.min_loss_samples:
            return None
        return estimate_walk_params_from_losses(
            losses, eta=self.cfg.eta, batch=self.cfg.base_batch
        )

    # ---- replanning ------------------------------------------------------
    def _replan(
        self,
        step: int,
        trigger: str,
        profile: CalibratedProfile,
        walk: WalkParams,
    ) -> ReplanEvent:
        t0 = time.perf_counter()
        tr0 = self.tracer.now() if self.tracer is not None else 0.0
        chosen: Optional["PartitionCandidate"] = None
        solves: Tuple = ()
        # the planner re-prices precision itself, so it consumes the
        # UNPRICED f32 baseline re-based by the fitted drift scales;
        # profile.times is the priced view x scales (what the wire saw)
        replan_times = scale_times(
            self.times, profile.comp_scale, profile.comm_scale
        )
        new_times = replan_times
        # precision is opt-in: cfg.wire_precision='f32' keeps the wire
        # frozen no matter what the link does (the pre-§13 contract).
        # When opted in, a bandwidth collapse (calibrated comm_scale at
        # or past the escalation bar) unlocks the full ladder for this
        # replan; short of the bar, 'auto' keeps the already-installed
        # policy, re-priced and re-gated as-is (precision=... path)
        wire_req = self.cfg.wire_precision
        collapse = profile.comm_scale >= self.cfg.precision_comm_scale
        if wire_req != "f32" and collapse:
            wire_req = "auto"
        elif wire_req == "auto":
            wire_req = "f32"    # no collapse: hold the current policy
        forced = self.precision if wire_req == "f32" else None
        if forced is not None and self.repartitioner is not None:
            # a repartition may change n_buckets, invalidating a forced
            # per-bucket policy — let the ladder re-derive one instead
            forced, wire_req = None, "auto"
        if self.repartitioner is None:
            res = self.planner.plan(PlanRequest(
                times=replan_times,
                walk=walk,
                wire_precision="f32" if forced is not None else wire_req,
                precision=forced,
                heterogeneous=self.scheduler_cfg.heterogeneous,
                mu=self.scheduler_cfg.mu,
                eps=self.cfg.eps,
                max_retries=self.cfg.max_retries,
                capacity_growth=self.cfg.capacity_growth,
            ))
            schedule, verdict, scfg = (
                res.schedule, res.verdict, res.scheduler_cfg
            )
        else:
            # candidate-partition path: the installed partition competes
            # against the repartitioner's grid, every candidate priced at
            # the CUMULATIVE calibrated drift and gated by the Preserver
            cum_comp = self._cum_comp * profile.comp_scale
            cum_comm = self._cum_comm * profile.comm_scale
            cands = self.repartitioner.candidates(
                self.bucket_of, self.times.n,
                comp_scale=cum_comp, comm_scale=cum_comm,
            )
            pairs = []
            for c in cands:
                if c.tag == "current":
                    pairs.append((c.tag, replan_times))
                else:
                    pairs.append((c.tag, self.repartitioner.times_for(
                        c, comp_scale=cum_comp, comm_scale=cum_comm
                    )))
            res = self.planner.plan(PlanRequest(
                candidates=tuple(pairs),
                walk=walk,
                wire_precision="f32" if forced is not None else wire_req,
                precision=forced,
                baseline_tag="current",
                min_gain=self.repartitioner.cfg.min_gain,
                heterogeneous=self.scheduler_cfg.heterogeneous,
                mu=self.scheduler_cfg.mu,
                eps=self.cfg.eps,
                max_retries=self.cfg.max_retries,
                capacity_growth=self.cfg.capacity_growth,
            ))
            solves = res.candidates
            best = next(
                s for s in solves if s.tag == res.winner_tag
            )
            schedule, verdict, scfg = (
                best.schedule, best.verdict, best.scheduler_cfg
            )
            new_times = best.times
            if best.tag != "current":
                chosen = next(c for c in cands if c.tag == best.tag)
            if res.precision is not None:
                # precision rides on top of the winning partition: the
                # winning policy's solve supersedes the f32 one
                schedule, verdict, scfg = (
                    res.schedule, res.verdict, res.scheduler_cfg
                )
        new_precision = res.precision
        wscale = 1.0
        for s in res.precision_candidates:
            if s.policy == res.precision:
                wscale = s.wire_bytes_scale
        old_wire = self.precision.wire if self.precision else None
        new_wire = new_precision.wire if new_precision else None
        replan_s = time.perf_counter() - t0
        event = ReplanEvent(
            step=step,
            trigger=trigger,
            profile=profile,
            old_coverage_rate=self.times.coverage_rate,
            new_coverage_rate=new_times.coverage_rate,
            old_period=self.schedule.period,
            new_period=schedule.period,
            old_batch_seq=tuple(self.schedule.batch_size_sequence),
            new_batch_seq=tuple(schedule.batch_size_sequence),
            verdict=verdict,
            schedule=schedule,
            scheduler_cfg=scfg,
            times=new_times,
            changed=(
                chosen is not None
                or schedule.phases != self.schedule.phases
                or old_wire != new_wire
            ),
            replan_s=replan_s,
            old_n_buckets=self.times.n,
            new_n_buckets=new_times.n,
            partition=chosen,
            candidate_solves=solves,
            old_precision=self.precision,
            new_precision=new_precision,
            wire_bytes_scale=wscale,
        )
        if self.tracer is not None:
            # the ReplanEvent as a trace span covering the solve
            self.tracer.add(
                "replan", trigger, tr0, self.tracer.now(), step=step,
                comp_scale=profile.comp_scale,
                comm_scale=profile.comm_scale,
                old_coverage_rate=event.old_coverage_rate,
                new_coverage_rate=event.new_coverage_rate,
                old_period=event.old_period,
                new_period=event.new_period,
                changed=event.changed,
                repartition=event.partition_changed,
                precision=(
                    new_precision.describe() if new_precision else "f32"
                ),
            )
        self.events.append(event)
        self._last_replan_step = step
        # the calibrated profile becomes the baseline the next check
        # compares against EVEN when the phases came out identical (a
        # no-op replan): the drift was real and is now accounted for —
        # without this the same deviation would re-trigger every
        # cooldown.  Telemetry re-keys at the new period; the widened
        # warm-up also swallows the old schedule's tail steps that run
        # before the runtime installs the swap at a cycle boundary.
        old_period = self.schedule.period
        self.times = new_times
        self.schedule = schedule
        self.scheduler_cfg = scfg
        self.precision = new_precision
        self._cum_comp *= profile.comp_scale
        self._cum_comm *= profile.comm_scale
        if chosen is not None:
            self.bucket_of = chosen.bucket_of
        self.telemetry.rebase(schedule.period, extra_warmup=old_period)
        return event

    # ---- reporting -------------------------------------------------------
    def stats(self) -> dict:
        return {
            "replans": len(self.events),
            "swaps_requested": sum(1 for e in self.events if e.changed),
            "repartitions": sum(
                1 for e in self.events if e.partition_changed
            ),
            "precision_changes": sum(
                1 for e in self.events if e.precision_changed
            ),
            "wire_precision": (
                self.precision.describe() if self.precision else "f32"
            ),
            "triggers": [e.trigger for e in self.events],
            "last_comp_scale": (
                self.events[-1].profile.comp_scale if self.events else 1.0
            ),
            "last_comm_scale": (
                self.events[-1].profile.comm_scale if self.events else 1.0
            ),
        }
