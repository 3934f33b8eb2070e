"""Measurement calibration: re-base the analytical profile from telemetry.

The Solver planned against an analytical :class:`BucketTimes` derived from
``HardwareModel`` napkin constants (peak FLOP/s * assumed MFU, nominal ICI
bandwidth).  Once the job is running we observe per-phase wall times; this
module inverts the timeline model to recover the two effective scalars the
hardware model got wrong:

* ``comp_scale`` — measured compute time / analytic (an MFU error),
* ``comm_scale`` — measured communication time / analytic (a bandwidth
  error, e.g. a congested or degraded link).

The forward model is the same discrete-event simulator the planner's
figures use: per-phase duration = f(BucketTimes scaled by (a, b), the
installed schedule's plans).  Because exposed communication is a
``max(0, ...)`` of overlap, the inverse is not linear — we fit (a, b) by a
coarse-to-fine grid search in log space against the measured per-phase
EMAs, which is exact enough (a few percent) at the 2-parameter scale and
costs a few hundred cheap simulator evaluations, all off the hot path.

The result is a :class:`CalibratedProfile`: re-based ``BucketTimes`` (what
the Solver re-consumes), an effective ``HardwareModel`` (ici_bw / mfu
re-fit — what a human reads in logs), and the rms fit residual.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.bucket import BucketTimes
from repro_torch.core.links import LinkModel
from repro_torch.core.profiler import HardwareModel
from repro_torch.core.scheduler import DeftScheduler, IterationPlan, SchedulerConfig
from repro_torch.core.simulator import simulate_deft

# cycle-extraction warm-up used by extract_schedule (core/scheduler.py):
# plans[_WARMUP + p + j*period] is the j-th occurrence of cycle phase p.
_WARMUP = 16


def scale_times(
    times: BucketTimes, comp_scale: float, comm_scale: float
) -> BucketTimes:
    return BucketTimes(
        tuple(f * comp_scale for f in times.fwd),
        tuple(b * comp_scale for b in times.bwd),
        tuple(c * comm_scale for c in times.comm),
    )


_PLANS_MEMO: dict = {}


def schedule_plans(
    times: BucketTimes, scfg: SchedulerConfig, horizon: Optional[int] = None
) -> List[IterationPlan]:
    """Regenerate the horizon plan list the installed schedule was cut
    from (same Solver inputs -> same deterministic plans).  Memoized —
    the controller re-derives the same plan list every check."""
    key = (
        times.fwd, times.bwd, times.comm,
        scfg.heterogeneous, scfg.mu, scfg.capacity_factor,
        horizon or scfg.horizon,
    )
    if key not in _PLANS_MEMO:
        if len(_PLANS_MEMO) > 256:
            _PLANS_MEMO.clear()
        _PLANS_MEMO[key] = DeftScheduler(times, scfg).run(
            horizon or scfg.horizon
        )
    return _PLANS_MEMO[key]


def fit_horizon(period: int) -> int:
    """Plan-list length for calibration fits: enough post-warm-up cycles
    to average, far shorter than the Solver's full 96-step horizon."""
    return _WARMUP + 4 * max(period, 1)


def steady_phase_durations(
    plans: Sequence[IterationPlan],
    run_times: BucketTimes,
    period: int,
    *,
    mu: float,
    heterogeneous: bool,
    link_models: Optional[Dict[int, LinkModel]] = None,
) -> Tuple[float, ...]:
    """Steady-state wall seconds of each cycle phase when the given plans
    execute under ``run_times`` (which may differ from the times the plans
    were solved for — that difference IS the drift being measured).
    ``link_models`` prices each link separately (DESIGN.md §14); None
    keeps the legacy scalar-``mu`` secondary."""
    sim = simulate_deft(
        run_times, plans, mu=mu, heterogeneous=heterogeneous,
        link_models=link_models,
    )
    durs = sim.iteration_durations
    out = []
    for p in range(period):
        occ = [
            durs[i]
            for i in range(_WARMUP + p, len(durs), period)
        ]
        # drop the last, possibly update-tail-truncated occurrence when
        # there are enough samples
        if len(occ) > 2:
            occ = occ[:-1]
        out.append(sum(occ) / max(len(occ), 1))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class CalibratedProfile:
    """The measurement-re-based profile the replanner consumes."""

    comp_scale: float           # measured / analytic compute time
    comm_scale: float           # measured / analytic comm time
    times: BucketTimes          # analytic times re-based by the scales
    hw: HardwareModel           # effective hardware model (logs / humans)
    residual: float             # rms per-phase fit residual, seconds
    planned: Tuple[float, ...]  # per-phase durations the plan assumed
    measured: Tuple[float, ...] # per-phase durations telemetry saw
    # per-link refinement (DESIGN.md §14): the secondary link's residual
    # inverse-bandwidth multiplier on top of comm_scale, and the fitted
    # LinkModels a heterogeneity-aware replan consumes
    # (``PlanRequest.link_models``).  1.0 / None without the refinement.
    sec_scale: float = 1.0
    link_models: Optional[Dict[int, LinkModel]] = None

    @property
    def drift(self) -> float:
        """Largest relative deviation of any fitted scale from 1."""
        return max(abs(self.comp_scale - 1.0), abs(self.comm_scale - 1.0),
                   abs(self.sec_scale - 1.0))


def _rms(xs: Sequence[float]) -> float:
    return math.sqrt(sum(x * x for x in xs) / max(len(xs), 1))


def planned_phase_durations(
    planned_times: BucketTimes, scfg: SchedulerConfig, period: int
) -> Tuple[float, ...]:
    """Per-phase durations the installed plan *assumed* — the cheap
    baseline the controller's steady-state fast path compares EMAs
    against before paying for a full 2-D fit."""
    plans = schedule_plans(planned_times, scfg, horizon=fit_horizon(period))
    return steady_phase_durations(
        plans, planned_times, period,
        mu=scfg.mu, heterogeneous=scfg.heterogeneous,
    )


def fit_scales(
    planned_times: BucketTimes,
    scfg: SchedulerConfig,
    period: int,
    measured: Sequence[Optional[float]],
    *,
    span: float = 32.0,
    coarse: int = 9,
    refine_rounds: int = 2,
    link_models: Optional[Dict[int, LinkModel]] = None,
) -> Tuple[float, float, float]:
    """Fit (comp_scale, comm_scale) so the simulated per-phase durations
    of the installed plans match the measured EMAs.  Log-space grid over
    ``[1/span, span]``, refined ``refine_rounds`` times around the best
    cell.  Returns (comp_scale, comm_scale, rms_residual).
    ``link_models`` fixes per-link pricing inside the forward model (the
    coordinate-descent partner of :func:`fit_secondary_scale`)."""
    plans = schedule_plans(planned_times, scfg, horizon=fit_horizon(period))
    obs = [(i, m) for i, m in enumerate(measured[:period]) if m is not None]
    if not obs:
        return 1.0, 1.0, 0.0
    # Exposed comm is max(0, .)-shaped: a link that got FASTER than
    # planned overlaps completely and becomes invisible, leaving whole
    # regions of (a, b) with identical predictions.  A small pull toward
    # (1, 1) makes the fit pick the least-surprising member of such a
    # plateau instead of an arbitrary corner that would read as drift.
    reg = 1e-3 * sum(m for _, m in obs) / len(obs)

    def loss(a: float, b: float) -> float:
        pred = steady_phase_durations(
            plans, scale_times(planned_times, a, b), period,
            mu=scfg.mu, heterogeneous=scfg.heterogeneous,
            link_models=link_models,
        )
        return _rms([pred[i] - m for i, m in obs]) + reg * (
            abs(math.log(a)) + abs(math.log(b))
        )

    best = (1.0, 1.0)
    best_l = loss(*best)
    lo_a = lo_b = -math.log(span)
    hi_a = hi_b = math.log(span)
    for _ in range(1 + refine_rounds):
        grid_a = [lo_a + (hi_a - lo_a) * i / (coarse - 1) for i in range(coarse)]
        grid_b = [lo_b + (hi_b - lo_b) * i / (coarse - 1) for i in range(coarse)]
        for la in grid_a:
            for lb in grid_b:
                l = loss(math.exp(la), math.exp(lb))
                if l < best_l:
                    best_l, best = l, (math.exp(la), math.exp(lb))
        # shrink the window around the current best cell
        ca, cb = math.log(best[0]), math.log(best[1])
        wa = (hi_a - lo_a) / (coarse - 1)
        wb = (hi_b - lo_b) / (coarse - 1)
        lo_a, hi_a = ca - wa, ca + wa
        lo_b, hi_b = cb - wb, cb + wb
    return best[0], best[1], best_l


def fit_secondary_scale(
    planned_times: BucketTimes,
    scfg: SchedulerConfig,
    period: int,
    measured: Sequence[Optional[float]],
    comp_scale: float,
    comm_scale: float,
    *,
    span: float = 8.0,
    coarse: int = 9,
    refine_rounds: int = 2,
) -> Tuple[float, Optional[Dict[int, LinkModel]], float]:
    """Per-link refinement of the 2-D fit (DESIGN.md §14).

    The joint ``comm_scale`` moves BOTH links together, so a
    secondary-only degradation (the common case: the slow host/DCN path
    congests while the primary fabric holds) aliases into it.  With the
    global scales pinned, this 1-D stage fits the secondary link's
    residual inverse-bandwidth multiplier by re-simulating the installed
    plans under per-link :class:`LinkModel` pricing.  Returns
    ``(sec_scale, link_models, rms_residual)`` — the models carry the
    fitted multiplier on top of the config's base models (latency terms
    preserved) and feed ``PlanRequest.link_models`` for the replan.
    ``(1.0, None, 0.0)`` when the setup is homogeneous or unobserved.
    """
    obs = [(i, m) for i, m in enumerate(measured[:period]) if m is not None]
    if not obs or not scfg.heterogeneous:
        return 1.0, None, 0.0
    plans = schedule_plans(planned_times, scfg, horizon=fit_horizon(period))
    run = scale_times(planned_times, comp_scale, comm_scale)
    base = scfg.models()
    reg = 1e-3 * sum(m for _, m in obs) / len(obs)

    def models_for(s: float) -> Dict[int, LinkModel]:
        return {
            lid: (m if lid == 0
                  else LinkModel(m.latency, m.inv_bw * s))
            for lid, m in base.items()
        }

    def loss(s: float) -> float:
        pred = steady_phase_durations(
            plans, run, period, mu=scfg.mu,
            heterogeneous=scfg.heterogeneous,
            link_models=models_for(s),
        )
        return _rms([pred[i] - m for i, m in obs]) + reg * abs(math.log(s))

    best_s = 1.0
    best_l = loss(best_s)
    lo, hi = -math.log(span), math.log(span)
    for _ in range(1 + refine_rounds):
        for i in range(coarse):
            ls = lo + (hi - lo) * i / (coarse - 1)
            l = loss(math.exp(ls))
            if l < best_l:
                best_l, best_s = l, math.exp(ls)
        w = (hi - lo) / (coarse - 1)
        c = math.log(best_s)
        lo, hi = c - w, c + w
    return best_s, models_for(best_s), best_l


def calibrate(
    planned_times: BucketTimes,
    scfg: SchedulerConfig,
    period: int,
    measured: Sequence[Optional[float]],
    hw: Optional[HardwareModel] = None,
    *,
    per_link: bool = False,
) -> CalibratedProfile:
    """Fit the effective scales and package the re-based profile.

    ``per_link=True`` adds the staged secondary-link refinement
    (:func:`fit_secondary_scale`): the profile then carries fitted
    :class:`LinkModel` s and its residual is the per-link fit's."""
    hw = hw or HardwareModel()
    a, b, resid = fit_scales(planned_times, scfg, period, measured)
    sec_scale, link_models = 1.0, None
    if per_link and scfg.heterogeneous:
        # coordinate descent: a secondary-only slowdown aliases into the
        # joint (a, b) fit, so alternate the 1-D per-link stage with
        # (a, b) re-fits under the fitted LinkModels until both views of
        # the measurements agree.  Two alternations suffice — each stage
        # is a regularized global grid search, not a local step.
        for _ in range(2):
            sec_scale, link_models, resid = fit_secondary_scale(
                planned_times, scfg, period, measured, a, b
            )
            if link_models is None:
                break
            a, b, resid = fit_scales(
                planned_times, scfg, period, measured,
                link_models=link_models,
            )
        if link_models is not None:
            sec_scale, link_models, resid = fit_secondary_scale(
                planned_times, scfg, period, measured, a, b
            )
    planned = planned_phase_durations(planned_times, scfg, period)
    eff_hw = dataclasses.replace(
        hw,
        # comm time scales inversely with bandwidth; compute time inversely
        # with achieved MFU.  These are *effective* values (they absorb
        # whatever the 2-scalar model cannot separate), for logs and for
        # re-profiling at a different shape.
        ici_bw=hw.ici_bw / max(b, 1e-9),
        mfu=hw.mfu / max(a, 1e-9),
    )
    return CalibratedProfile(
        comp_scale=a,
        comm_scale=b,
        times=scale_times(planned_times, a, b),
        hw=eff_hw,
        residual=resid,
        planned=planned,
        measured=tuple(
            m if m is not None else p for m, p in zip(measured, planned)
        ),
        sec_scale=sec_scale,
        link_models=link_models,
    )
