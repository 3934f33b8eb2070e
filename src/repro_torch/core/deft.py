"""DeFT top level: Profiler -> Solver -> Preserver feedback loop (Fig. 7).

:class:`Planner` is the single planning surface: every consumer (train
driver, adaptive controller, elastic controller, benchmarks) builds a
:class:`PlanRequest` and receives a :class:`PlanResult`.  The request
carries the input source (profiled ``times``, a candidate-partition
grid, or an architecture + hardware model to profile analytically), the
Preserver policy, the solver knobs, and — for the decoupled-collective
item model (DESIGN.md §12) — the all-gather streaming knobs.

Decoupled item model
--------------------
With ``PlanRequest.decoupled`` the fused per-bucket sync is split into
two independently schedulable knapsack items the way DeAR decouples
all-reduce: a *reduce-scatter* item (``(1 - ag_fraction)`` of the wire
time) placed against backward capacity by the existing two-stage Solver,
and an *all-gather* item streamed against the forward pass.  AG items
carry a **deadline** — the forward-prefix time at which the first block
consuming the bucket starts (buckets are in model order, so bucket ``b``
must land before forward block ``b``) — and are placed by the
deadline-constrained knapsack; a late AG stalls the consuming forward
block instead of adding a bubble.

The legacy functions (``solve_schedule`` / ``feedback_solve`` /
``feedback_solve_candidates`` / ``plan_deft``) remain as thin deprecated
shims over the Planner; new call sites must use the facade
(``scripts/check_no_legacy_planner.py`` enforces this in CI).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.core.bucket import BucketTimes
from repro_torch.core.knapsack import deadline_knapsack
from repro_torch.core.links import LinkModel
from repro_torch.core.precision import (
    PRECISION_SIGMA_GAIN,
    PrecisionPolicy,
    apply_wire_precision,
    check_precision_schedule,
)
from repro_torch.core.preserver import PreserverVerdict, WalkParams, check_schedule
from repro_torch.core.profiler import HardwareModel, Profile, profile_arch
from repro_torch.core.scheduler import (
    DeftSchedule,
    DeftScheduler,
    SchedulerConfig,
    extract_schedule,
)


@dataclasses.dataclass(frozen=True)
class DeftPlan:
    """Everything downstream consumers need (legacy ``plan_deft`` shape)."""

    profile: Profile
    schedule: DeftSchedule
    verdict: PreserverVerdict
    capacity_factor: float       # final (post-feedback) knapsack scale
    retries: int
    scheduler_cfg: SchedulerConfig

    @property
    def coverage_rate(self) -> float:
        return self.profile.coverage_rate


# ---------------------------------------------------------------------------
# Decoupled-collective item model (DESIGN.md §12)
# ---------------------------------------------------------------------------
def ag_times(times: BucketTimes, ag_fraction: float = 0.5) -> Tuple[float, ...]:
    """Per-bucket all-gather seconds under the decoupled item model.

    A ring all-reduce is a reduce-scatter plus an all-gather moving the
    same bytes each, so the default split prices the AG half at half the
    profiled fused wire time; ``ag_fraction`` is the tunable split for
    asymmetric implementations."""
    if not 0.0 <= ag_fraction <= 1.0:
        raise ValueError(f"ag_fraction must be in [0, 1], got {ag_fraction}")
    return tuple(ag_fraction * c for c in times.comm)


def rs_times(times: BucketTimes, ag_fraction: float = 0.5) -> BucketTimes:
    """The reduce-scatter remainder of ``times`` once the AG half is
    split off: identical compute, comm scaled to ``1 - ag_fraction``."""
    if not 0.0 <= ag_fraction <= 1.0:
        raise ValueError(f"ag_fraction must be in [0, 1], got {ag_fraction}")
    return BucketTimes(
        fwd=times.fwd,
        bwd=times.bwd,
        comm=tuple((1.0 - ag_fraction) * c for c in times.comm),
    )


def ag_deadlines(times: BucketTimes) -> Tuple[float, ...]:
    """Deadline of bucket ``b``'s AG item: the forward-prefix time at
    which block ``b`` (the first consumer, model order) starts."""
    acc, out = 0.0, []
    for f in times.fwd:
        out.append(acc)
        acc += f
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class AgItem:
    """One all-gather knapsack item: bucket ``bucket`` streamed during
    the forward of cycle position ``phase``."""

    bucket: int
    phase: int
    duration: float              # seconds on the primary link
    deadline: float              # forward-prefix start of the consumer
    link: int                    # 0 = primary, 1 = secondary (plan-level)
    covered: bool                # meets its deadline in the placement


@dataclasses.dataclass(frozen=True)
class AgStreamPlan:
    """Deadline-knapsack placement of the AG items over one cycle."""

    items: Tuple[AgItem, ...]
    period: int
    ag_fraction: float
    capacity: float              # forward window per phase (seconds)

    def items_for_phase(self, t: int) -> Tuple[AgItem, ...]:
        return tuple(i for i in self.items if i.phase == t)

    @property
    def total_s(self) -> float:
        return sum(i.duration for i in self.items)

    @property
    def covered_s(self) -> float:
        return sum(i.duration for i in self.items if i.covered)

    @property
    def coverage(self) -> float:
        """Fraction of AG wire time hidden behind forward compute
        (1.0 when there are no AG items at all)."""
        total = self.total_s
        return 1.0 if total <= 0.0 else self.covered_s / total


def ag_sim_kwargs(ag_plan: Optional[AgStreamPlan]):
    """Per-bucket ``(durations, links)`` of the first gathering phase —
    the shape ``simulate_deft(ag_times=..., ag_links=...)`` consumes.
    Every gathering phase places the same full bucket set, so the first
    one is representative; returns ``(None, None)`` when the plan has no
    items (pure-stale cycle or no plan at all)."""
    if ag_plan is None or not ag_plan.items:
        return None, None
    t0 = ag_plan.items[0].phase
    nb = max(i.bucket for i in ag_plan.items) + 1
    durs = [0.0] * nb
    links = [0] * nb
    for item in ag_plan.items_for_phase(t0):
        durs[item.bucket] = item.duration
        links[item.bucket] = item.link
    return tuple(durs), tuple(links)


def plan_ag_stream(
    schedule: DeftSchedule,
    times: BucketTimes,
    scfg: Optional[SchedulerConfig] = None,
    *,
    ag_fraction: float = 0.5,
    gather_skip: bool = True,
) -> AgStreamPlan:
    """Place the per-cycle all-gather items against forward capacity.

    A cycle position gathers iff its params are *fresh* — position 0, or
    the previous phase applied an update — matching the runtime's
    gather-reuse masks exactly; with ``gather_skip`` the stale positions
    emit **no AG items** (the runtime serves them from the replicated
    cache).  Fresh positions gather every bucket; each position's items
    go through the deadline-constrained knapsack on the primary link,
    then (heterogeneous setups) the leftovers are re-offered to the
    secondary link at ``mu``-scaled durations.  Items covered by neither
    stall their consuming forward block (the simulator prices the
    stall)."""
    scfg = scfg or SchedulerConfig()
    durs = ag_times(times, ag_fraction)
    deadlines = ag_deadlines(times)
    nb = times.n
    cap = times.fwd_total * scfg.capacity_factor
    items = []
    for t in range(schedule.period):
        fresh = t == 0 or schedule.phases[t - 1].do_update
        if gather_skip and not fresh:
            continue
        sel = set(deadline_knapsack(durs, deadlines, cap))
        rest = [b for b in range(nb) if b not in sel]
        sel2 = set()
        if scfg.heterogeneous and rest:
            if scfg.link_models is None:
                sec_durs = [durs[b] * scfg.mu for b in rest]
            else:
                lm1 = scfg.models().get(1, LinkModel(0.0, scfg.mu))
                sec_durs = [lm1.time(durs[b]) for b in rest]
            picked = deadline_knapsack(
                sec_durs,
                [deadlines[b] for b in rest],
                cap,
            )
            sel2 = {rest[j] for j in picked}
        for b in range(nb):
            items.append(AgItem(
                bucket=b,
                phase=t,
                duration=durs[b],
                deadline=deadlines[b],
                link=1 if b in sel2 else 0,
                covered=b in sel or b in sel2,
            ))
    return AgStreamPlan(
        items=tuple(items),
        period=schedule.period,
        ag_fraction=ag_fraction,
        capacity=cap,
    )


# ---------------------------------------------------------------------------
# Planner facade
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PlanRequest:
    """One planning request; exactly one input source must be set:

    * ``times``      — profiled/calibrated bucket times (train driver,
                       adaptive controller);
    * ``candidates`` — ``(tag, BucketTimes)`` partition grid scored by
                       simulated iteration time (repartitioner, elastic);
    * ``arch``       — architecture profiled analytically against ``hw``
                       (the ``plan_deft`` path).
    """

    times: Optional[BucketTimes] = None
    candidates: Tuple[Tuple[str, BucketTimes], ...] = ()
    arch: Optional[ArchConfig] = None

    # analytic-profile knobs (arch path)
    hw: Optional[HardwareModel] = None
    seq_len: int = 4096
    per_device_batch: int = 1
    partition_elems: int = 6_500_000
    rebase_total_flops: Optional[float] = None

    # Preserver policy
    walk: Optional[WalkParams] = None
    preserve: bool = True        # False: single solve, no Preserver gate
    eps: float = 0.01
    max_retries: int = 10
    capacity_growth: float = 1.2
    initial_factor: float = 1.0

    # solver knobs
    heterogeneous: bool = True
    mu: float = 1.65
    warmup: int = 16
    # per-link latency + inverse-bandwidth models (heterogeneous-link
    # pricing); None = legacy scalar ``mu``
    link_models: Optional[Dict[int, LinkModel]] = None

    # candidate scoring (candidates path)
    baseline_tag: Optional[str] = None
    min_gain: float = 0.0
    sim_iterations: int = 48

    # decoupled-collective item model (§12)
    decoupled: bool = False
    ag_fraction: float = 0.5
    gather_skip: bool = True

    # wire precision (§13): "f32" (off), a forced uniform dtype
    # ("bf16"/"int8"), or "auto" — enumerate per-bucket policies along a
    # largest-comm-first downgrade ladder, each scored by simulated
    # iteration time and gated by the precision-aware Preserver check.
    # An explicit ``precision`` policy overrides the enumeration.
    wire_precision: str = "f32"
    master_dtype: str = "f32"
    precision: Optional[PrecisionPolicy] = None
    precision_min_gain: float = 0.0
    precision_sigma_gain: float = PRECISION_SIGMA_GAIN

    def __post_init__(self):
        sources = (
            (self.times is not None)
            + bool(self.candidates)
            + (self.arch is not None)
        )
        if sources != 1:
            raise ValueError(
                "PlanRequest needs exactly one of times / candidates / "
                f"arch, got {sources}"
            )
        if self.wire_precision not in ("auto", "f32", "bf16", "int8"):
            raise ValueError(
                f"wire_precision must be auto/f32/bf16/int8, got "
                f"{self.wire_precision!r}"
            )
        if self.master_dtype not in ("f32", "bf16sr"):
            raise ValueError(
                f"master_dtype must be f32/bf16sr, got {self.master_dtype!r}"
            )
        if self.precision is not None and self.wire_precision != "f32":
            raise ValueError(
                "pass an explicit precision policy OR wire_precision, "
                "not both"
            )


@dataclasses.dataclass(frozen=True)
class PlanResult:
    """What the Planner returns, superset of every legacy surface."""

    schedule: DeftSchedule
    verdict: Optional[PreserverVerdict]
    scheduler_cfg: SchedulerConfig
    retries: int
    times: BucketTimes                     # profiled (f32-priced) times
    profile: Optional[Profile] = None      # arch path only
    candidates: Tuple[CandidateSolve, ...] = ()
    winner_tag: Optional[str] = None       # candidates path only
    ag_plan: Optional[AgStreamPlan] = None  # decoupled requests only
    # §13: adopted wire-precision policy + the times re-priced under it
    # (the times the schedule actually solved on); None when the request
    # did not engage precision planning
    precision: Optional[PrecisionPolicy] = None
    priced_times: Optional[BucketTimes] = None
    precision_candidates: Tuple["PrecisionSolve", ...] = ()

    @property
    def capacity_factor(self) -> float:
        return self.scheduler_cfg.capacity_factor

    @property
    def ok(self) -> bool:
        return self.verdict is None or self.verdict.ok

    @property
    def wire_times(self) -> BucketTimes:
        """The precision-priced times every downstream consumer (AG
        streaming, simulator, runtime) should execute against."""
        return self.priced_times if self.priced_times is not None else self.times


@dataclasses.dataclass(frozen=True)
class PrecisionSolve:
    """One precision policy's pass through the feedback loop (§13)."""

    policy: PrecisionPolicy
    schedule: DeftSchedule
    verdict: Optional[PreserverVerdict]
    scheduler_cfg: SchedulerConfig
    retries: int
    iteration_time: float        # simulated steady-state seconds/iteration
    coverage: float              # simulated 1 - bubble_fraction
    wire_bytes_scale: float      # policy wire bytes / all-f32 wire bytes


class Planner:
    """The unified planning facade (solve + Preserver feedback +
    candidate scoring + decoupled AG streaming + wire-precision
    enumeration) behind one ``plan(PlanRequest) -> PlanResult`` call.

    Stateless apart from an optional default Gaussian-walk model applied
    when a request does not carry its own."""

    _DEFAULT_WALK = WalkParams(s0=4.0, eta=0.01, mu=1.0, sigma=40.0,
                               batch=256)

    def __init__(self, walk: Optional[WalkParams] = None):
        self.default_walk = walk

    # -- internals ----------------------------------------------------------
    def _walk(self, req: PlanRequest) -> WalkParams:
        return req.walk or self.default_walk or self._DEFAULT_WALK

    def _solve_times(
        self,
        times: BucketTimes,
        req: PlanRequest,
        policy: Optional[PrecisionPolicy] = None,
        weight_times: Optional[BucketTimes] = None,
    ):
        """Fig. 7 feedback loop over one set of bucket times.

        With ``policy`` the Preserver check is the precision-aware one
        (§13): the fixed-B reference rolls the clean walk while DeFT's
        sequence carries the policy's quantization noise.
        ``weight_times`` supplies the f32 comm weights for the sigma
        inflation (``times`` may already be precision-priced)."""
        walk = self._walk(req)
        factor = req.initial_factor
        schedule, verdict, scfg, retry = None, None, None, 0
        retries = 0 if not req.preserve else req.max_retries
        for retry in range(retries + 1):
            scfg = SchedulerConfig(
                heterogeneous=req.heterogeneous, mu=req.mu,
                capacity_factor=factor,
                link_models=req.link_models,
            )
            schedule = self._solve(times, scfg, warmup=req.warmup)
            if not req.preserve:
                verdict = None
                break
            if policy is None:
                verdict = check_schedule(
                    schedule.batch_size_sequence, schedule.period, walk,
                    eps=req.eps,
                )
            else:
                verdict = check_precision_schedule(
                    schedule.batch_size_sequence, schedule.period, walk,
                    policy, weight_times or times, eps=req.eps,
                    gain=req.precision_sigma_gain,
                )
            if verdict.ok:
                break
            factor *= req.capacity_growth
        return schedule, verdict, scfg, retry

    @staticmethod
    def _solve(
        times: BucketTimes,
        scfg: SchedulerConfig,
        n_buckets: Optional[int] = None,
        warmup: int = 16,
    ) -> DeftSchedule:
        """Solver: Algorithm 2 over the horizon, then cycle extraction."""
        sched = DeftScheduler(times, scfg)
        plans = sched.run()
        return extract_schedule(plans, n_buckets or times.n, warmup=warmup)

    @staticmethod
    def _ag_sim_kwargs(schedule, times: BucketTimes,
                       scfg: SchedulerConfig, req: PlanRequest) -> dict:
        """Streamed-AG kwargs for candidate scoring.

        A decoupled request must be priced with its AG items on their
        *planned links* — without this every gather simulates on the
        primary link, mispricing exactly the candidates whose plan
        off-loaded gathers to the secondary link (the ranking can flip).
        ``times`` are the full (unsplit) bucket times the AG items derive
        from."""
        if not req.decoupled:
            return {}
        agp = plan_ag_stream(
            schedule, times, scfg,
            ag_fraction=req.ag_fraction,
            gather_skip=req.gather_skip,
        )
        durs, links = ag_sim_kwargs(agp)
        if durs is None:
            return {}
        return {"ag_times": durs, "ag_links": links,
                "ag_skip": req.gather_skip}

    def _plan_candidates(self, req: PlanRequest):
        """Candidate-partition path: run the feedback loop over SEVERAL
        bucket partitions of the same model, score each by simulated
        steady-state iteration time, and pick the winner.

        The Preserver gates partition changes exactly like k-sequence
        changes: a candidate whose schedule still fails after the
        capacity feedback retries is disqualified (unless it IS the
        baseline — best-effort semantics).  ``min_gain`` adds switch
        hysteresis so a near-tie never pays a state re-pack."""
        from repro_torch.core.simulator import simulate_deft

        solves = []
        for tag, times in req.candidates:
            solve_on = rs_times(times, req.ag_fraction) if req.decoupled \
                else times
            schedule, verdict, scfg, retries = self._solve_times(solve_on, req)
            sim = simulate_deft(
                solve_on,
                DeftScheduler(solve_on, scfg).run(req.sim_iterations),
                mu=scfg.mu,
                heterogeneous=scfg.heterogeneous,
                link_models=scfg.link_models,
                **self._ag_sim_kwargs(schedule, times, scfg, req),
            )
            solves.append(CandidateSolve(
                tag=tag,
                times=times,
                schedule=schedule,
                verdict=verdict,
                scheduler_cfg=scfg,
                retries=retries,
                iteration_time=sim.iteration_time,
            ))
        if not solves:
            raise ValueError("candidate path needs >= 1 candidate")
        base = next(
            (s for s in solves if s.tag == req.baseline_tag), solves[0]
        )
        best = base
        for s in solves:
            if s is base or not s.verdict.ok:
                continue
            bar = best.iteration_time
            if best is base:
                bar = base.iteration_time * (1.0 - req.min_gain)
            if s.iteration_time < bar:
                best = s
        return best, tuple(solves)

    # -- precision enumeration (§13) ----------------------------------------
    @staticmethod
    def _precision_requested(req: PlanRequest) -> bool:
        return (
            req.precision is not None
            or req.wire_precision != "f32"
            or req.master_dtype != "f32"
        )

    @staticmethod
    def _precision_ladder(times: BucketTimes, req: PlanRequest):
        """Candidate policies, all-f32 baseline first.

        ``auto`` walks a largest-comm-first downgrade ladder: buckets
        flip f32 -> bf16 one at a time in descending f32 comm order,
        then bf16 -> int8 in the same order — ``2n + 1`` monotone
        candidates whose quantization noise only grows, so the first
        gate failure ends the scan (the ladder prefix property makes
        mixed assignments first-class: the winner is whatever prefix
        simulates fastest, not an all-or-nothing dtype flip)."""
        n = times.n
        base = PrecisionPolicy.uniform(n, "f32", req.master_dtype)
        if req.precision is not None:
            return [base, req.precision]
        if req.wire_precision != "auto":
            forced = PrecisionPolicy.uniform(
                n, req.wire_precision, req.master_dtype
            )
            return [base] if forced == base else [base, forced]
        order = sorted(range(n), key=lambda b: -times.comm[b])
        ladder = [base]
        cur = base
        for target in ("bf16", "int8"):
            for b in order:
                cur = cur.with_wire(b, target)
                ladder.append(cur)
        return ladder

    def _solve_precision(
        self, times: BucketTimes, req: PlanRequest,
        policy: PrecisionPolicy,
    ) -> PrecisionSolve:
        from repro_torch.core.simulator import simulate_deft

        priced = apply_wire_precision(times, policy)
        solve_on = rs_times(priced, req.ag_fraction) if req.decoupled \
            else priced
        schedule, verdict, scfg, retries = self._solve_times(
            solve_on, req, policy=policy, weight_times=times,
        )
        sim = simulate_deft(
            solve_on,
            DeftScheduler(solve_on, scfg).run(req.sim_iterations),
            mu=scfg.mu,
            heterogeneous=scfg.heterogeneous,
            link_models=scfg.link_models,
            **self._ag_sim_kwargs(schedule, priced, scfg, req),
        )
        # wire-volume scale vs all-f32, weighted by each bucket's f32
        # comm time (proportional to its bytes — BucketTimes carries no
        # element counts)
        tot = max(times.comm_total, 1e-30)
        scale = sum(
            times.comm[b] * policy.wire_bytes_per_elem(b) / 4.0
            for b in range(times.n)
        ) / tot
        return PrecisionSolve(
            policy=policy,
            schedule=schedule,
            verdict=verdict,
            scheduler_cfg=scfg,
            retries=retries,
            iteration_time=sim.iteration_time,
            coverage=max(0.0, 1.0 - sim.bubble_fraction),
            wire_bytes_scale=scale,
        )

    def _plan_precision(self, times: BucketTimes, req: PlanRequest):
        """Score the precision ladder; adopt the fastest gate-passing
        policy.  All-f32 is the best-effort baseline (kept even when its
        own verdict fails, mirroring the candidate-partition path);
        ``precision_min_gain`` adds switch hysteresis.  An EXPLICIT
        policy (``req.precision`` or a forced uniform wire) is adopted
        whenever the gate allows it — the caller asked for those bytes,
        so a time tie (e.g. every rung latency-floored on a tiny
        profile) must not silently fall back to f32."""
        ladder = self._precision_ladder(times, req)
        solves = [self._solve_precision(times, req, ladder[0])]
        for policy in ladder[1:]:
            s = self._solve_precision(times, req, policy)
            solves.append(s)
            if req.preserve and not s.verdict.ok and \
                    req.wire_precision == "auto":
                break   # noise grows monotonically along the ladder
        base = solves[0]
        explicit = req.precision is not None or \
            req.wire_precision not in ("auto", "f32")
        if explicit and len(solves) > 1:
            forced = solves[-1]
            if not req.preserve or forced.verdict.ok:
                return forced, tuple(solves)
            return base, tuple(solves)
        best = base
        for s in solves[1:]:
            if req.preserve and not s.verdict.ok:
                continue
            bar = best.iteration_time
            if best is base:
                bar = base.iteration_time * (1.0 - req.precision_min_gain)
            if s.iteration_time < bar:
                best = s
        return best, tuple(solves)

    # -- the facade ---------------------------------------------------------
    def plan(self, req: PlanRequest) -> PlanResult:
        profile = None
        candidates: Tuple[CandidateSolve, ...] = ()
        winner_tag = None

        if req.candidates:
            best, candidates = self._plan_candidates(req)
            times = best.times
            schedule, verdict = best.schedule, best.verdict
            scfg, retries = best.scheduler_cfg, best.retries
            winner_tag = best.tag
        else:
            if req.arch is not None:
                profile = profile_arch(
                    req.arch,
                    hw=req.hw or HardwareModel(),
                    seq_len=req.seq_len,
                    per_device_batch=req.per_device_batch,
                    partition_strategy="deft",
                    partition_elems=req.partition_elems,
                    rebase_total_flops=req.rebase_total_flops,
                )
                times = profile.times
            else:
                times = req.times
            solve_on = rs_times(times, req.ag_fraction) if req.decoupled \
                else times
            schedule, verdict, scfg, retries = self._solve_times(solve_on, req)

        precision = None
        priced_times = None
        precision_candidates: Tuple[PrecisionSolve, ...] = ()
        if self._precision_requested(req):
            # precision rides on top of whichever times won above (the
            # candidate path re-prices the winning partition); the
            # winning policy's solve replaces the f32 one
            best_p, precision_candidates = self._plan_precision(times, req)
            precision = best_p.policy
            priced_times = apply_wire_precision(times, precision)
            schedule, verdict = best_p.schedule, best_p.verdict
            scfg, retries = best_p.scheduler_cfg, best_p.retries

        ag_plan = None
        if req.decoupled:
            ag_plan = plan_ag_stream(
                schedule, priced_times if priced_times is not None else times,
                scfg,
                ag_fraction=req.ag_fraction,
                gather_skip=req.gather_skip,
            )
        return PlanResult(
            schedule=schedule,
            verdict=verdict,
            scheduler_cfg=scfg,
            retries=retries,
            times=times,
            profile=profile,
            candidates=candidates,
            winner_tag=winner_tag,
            ag_plan=ag_plan,
            precision=precision,
            priced_times=priced_times,
            precision_candidates=precision_candidates,
        )


# ---------------------------------------------------------------------------
# Legacy shims (deprecated: new call sites must go through Planner —
# scripts/check_no_legacy_planner.py enforces this for src/repro)
# ---------------------------------------------------------------------------
def solve_schedule(
    times: BucketTimes,
    scfg: SchedulerConfig,
    n_buckets: Optional[int] = None,
    warmup: int = 16,
) -> DeftSchedule:
    """Deprecated shim: raw Solver pass.  Use ``Planner.plan`` with
    ``preserve=False`` (or keep the SchedulerConfig knobs on the
    request) instead."""
    return Planner._solve(times, scfg, n_buckets=n_buckets, warmup=warmup)


def feedback_solve(
    times: BucketTimes,
    walk: WalkParams,
    *,
    heterogeneous: bool = True,
    mu: float = 1.65,
    eps: float = 0.01,
    max_retries: int = 10,
    capacity_growth: float = 1.2,
    initial_factor: float = 1.0,
) -> Tuple[DeftSchedule, PreserverVerdict, SchedulerConfig, int]:
    """Deprecated shim: the Fig. 7 feedback loop over profiled bucket
    times.  Use ``Planner.plan(PlanRequest(times=...))``."""
    res = Planner().plan(PlanRequest(
        times=times,
        walk=walk,
        heterogeneous=heterogeneous,
        mu=mu,
        eps=eps,
        max_retries=max_retries,
        capacity_growth=capacity_growth,
        initial_factor=initial_factor,
    ))
    return res.schedule, res.verdict, res.scheduler_cfg, res.retries


@dataclasses.dataclass(frozen=True)
class CandidateSolve:
    """One partition candidate's pass through the feedback loop."""

    tag: str
    times: BucketTimes
    schedule: DeftSchedule
    verdict: PreserverVerdict
    scheduler_cfg: SchedulerConfig
    retries: int
    iteration_time: float        # simulated steady-state seconds/iteration


def feedback_solve_candidates(
    candidates,
    walk: WalkParams,
    *,
    baseline_tag: Optional[str] = None,
    min_gain: float = 0.0,
    sim_iterations: int = 48,
    heterogeneous: bool = True,
    mu: float = 1.65,
    eps: float = 0.01,
    max_retries: int = 10,
    capacity_growth: float = 1.2,
) -> Tuple[CandidateSolve, Tuple[CandidateSolve, ...]]:
    """Deprecated shim: candidate-partition scoring.  Use
    ``Planner.plan(PlanRequest(candidates=...))``."""
    res = Planner().plan(PlanRequest(
        candidates=tuple(candidates),
        walk=walk,
        baseline_tag=baseline_tag,
        min_gain=min_gain,
        sim_iterations=sim_iterations,
        heterogeneous=heterogeneous,
        mu=mu,
        eps=eps,
        max_retries=max_retries,
        capacity_growth=capacity_growth,
    ))
    best = next(s for s in res.candidates if s.tag == res.winner_tag)
    return best, res.candidates


def plan_deft(
    cfg: ArchConfig,
    hw: HardwareModel = HardwareModel(),
    seq_len: int = 4096,
    per_device_batch: int = 1,
    heterogeneous: bool = True,
    mu: float = 1.65,
    walk: Optional[WalkParams] = None,
    eps: float = 0.01,
    max_retries: int = 10,
    capacity_growth: float = 1.2,
    partition_elems: int = 6_500_000,
    rebase_total_flops: Optional[float] = None,
) -> DeftPlan:
    """Deprecated shim: profile -> solve -> preserve.  Use
    ``Planner.plan(PlanRequest(arch=...))``."""
    res = Planner(walk=walk).plan(PlanRequest(
        arch=cfg,
        hw=hw,
        seq_len=seq_len,
        per_device_batch=per_device_batch,
        heterogeneous=heterogeneous,
        mu=mu,
        eps=eps,
        max_retries=max_retries,
        capacity_growth=capacity_growth,
        partition_elems=partition_elems,
        rebase_total_flops=rebase_total_flops,
    ))
    return DeftPlan(
        profile=res.profile,
        schedule=res.schedule,
        verdict=res.verdict,
        capacity_factor=res.capacity_factor,
        retries=res.retries,
        scheduler_cfg=res.scheduler_cfg,
    )
