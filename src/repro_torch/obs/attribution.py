"""Span -> paper-metric attribution (DESIGN.md §11).

The planner reasons in the paper's vocabulary — coverage rate, bubbles,
knapsack capacity — but the running job only produces wall-clock spans.
This module closes the loop in both directions:

* **live path** (:func:`attribute`, :func:`attribute_trace`): align the
  measured per-phase durations against the installed schedule's
  predicted per-phase durations, fit the two calibration scales
  (``adapt/calibrate.py``), and re-run the timeline simulator at the
  calibrated scales to report *measured* coverage rate, per-bucket
  bubble seconds, and knapsack capacity utilization — plus the raw
  predicted-vs-actual divergence per phase and per bucket, which is the
  early-warning signal the controller's EMA smoothing delays.
* **closure path** (:func:`spans_from_sim`,
  :func:`sim_metrics_from_spans`): a ``SimResult`` timeline converts to
  synthetic spans and back; the reconstructed iteration time / bubble
  fraction / coverage rate must reproduce the simulator's own numbers
  (the ground-truth closure test in ``tests/test_obs.py``).

Alignment rules (§11): measured phase durations are *schedule-relative*
(keyed by position in the installed cycle, re-based on hot-swap exactly
like ``Telemetry``); predicted durations use the same ``_WARMUP``/
period slicing as ``steady_phase_durations``; first-dispatch spans are
excluded (compile pollution, see the ``first`` span tag).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.adapt.calibrate import (
    fit_horizon,
    fit_scales,
    planned_phase_durations,
    schedule_plans,
    scale_times,
)
from repro_torch.core.bucket import BucketTimes
from repro_torch.core.links import effective_mu
from repro_torch.core.scheduler import DeftSchedule, SchedulerConfig
from repro_torch.core.simulator import SimResult, simulate_deft
from repro_torch.obs.trace import Span, Tracer


# ---------------------------------------------------------------------------
# SimResult -> spans (closure path; also the explorer's --trace export)
# ---------------------------------------------------------------------------

def spans_from_sim(sim: SimResult) -> List[Span]:
    """Convert a kept timeline into spans.

    Iteration (``step``) bounds are reconstructed exactly: iteration
    ``it`` starts where its ``F0@it`` compute op starts (the simulator
    appends ``iter_starts`` immediately before forward compute), and the
    final iteration ends at ``start + iteration_durations[-1]``.
    Compute ops become ``compute`` spans, link transmissions become
    ``collective`` spans tagged with their bucket and link.
    """
    if sim.timeline is None:
        raise ValueError(
            "SimResult has no timeline — simulate with keep_timeline=True"
        )
    spans: List[Span] = []
    starts: Dict[int, float] = {}
    for stream, s, e, label in sim.timeline:
        if stream == "compute":
            op = label[0]
            bucket_s, it_s = label[1:].split("@")
            b, it = int(bucket_s), int(it_s)
            if op == "F" and b == 0:
                starts[it] = s
            spans.append(Span(
                "compute", label, s, e, step=it,
                attrs=(("bucket", b), ("op", op)),
            ))
        else:  # link0 / link1
            link = int(stream[len("link"):])
            body = label[1:]
            # split item model (§12): G{bucket}@{iter} is a streamed
            # all-gather item, C… the grad-sync (RS/all-reduce) item
            op = "ag" if label[0] == "G" else "grad"
            if "~" in body:          # DeFT: C{bucket}~{origins}
                bucket_s, origins = body.split("~", 1)
                it = None
            else:                    # baseline C / AG: {bucket}@{iter}
                bucket_s, it_s = body.split("@", 1)
                origins, it = "", int(it_s)
            spans.append(Span(
                "collective", label, s, e, step=it,
                track=f"sim-link{link}",
                attrs=(("bucket", int(bucket_s)), ("link", link),
                       ("origins", origins), ("op", op)),
            ))
    n = len(sim.iteration_durations)
    for it in range(n):
        t0 = starts[it]
        t1 = starts[it + 1] if it + 1 in starts else t0 + sim.iteration_durations[it]
        spans.append(Span("step", f"iter{it}", t0, t1, step=it))
    spans.sort(key=lambda sp: (sp.t0, sp.t1, sp.name))
    return spans


def _clip(intervals: Iterable[Tuple[float, float]], a: float, b: float
          ) -> List[Tuple[float, float]]:
    out = []
    for s, e in intervals:
        s2, e2 = max(s, a), min(e, b)
        if e2 > s2:
            out.append((s2, e2))
    return out


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def timeline_bubbles(
    spans: Sequence[Span], t_a: float, t_b: float
) -> Tuple[float, Dict[int, float], Dict[int, float]]:
    """Decompose compute-stream idle time inside ``[t_a, t_b]``.

    Returns ``(total_idle_s, exposed_by_bucket, busy_by_link)``:
    ``exposed_by_bucket[b]`` is the portion of compute-idle time that a
    collective of bucket ``b`` was occupying a link for — the paper's
    per-bucket *bubble* (comm that slipped out of its knapsack slot and
    stalled compute).  Overlapping links may attribute the same idle
    moment to two buckets; the attribution is per-cause, not a
    partition.  ``busy_by_link`` is wall busy-seconds per link id.
    """
    busy = _merge(_clip(
        [(sp.t0, sp.t1) for sp in spans if sp.kind == "compute"], t_a, t_b
    ))
    idle: List[Tuple[float, float]] = []
    cur = t_a
    for s, e in busy:
        if s > cur:
            idle.append((cur, s))
        cur = max(cur, e)
    if cur < t_b:
        idle.append((cur, t_b))
    total_idle = sum(e - s for s, e in idle)

    exposed: Dict[int, float] = {}
    link_busy: Dict[int, float] = {}
    for sp in spans:
        if sp.kind != "collective":
            continue
        args = sp.args
        b = int(args.get("bucket", -1))
        link = int(args.get("link", 0))
        for s, e in _clip([(sp.t0, sp.t1)], t_a, t_b):
            link_busy[link] = link_busy.get(link, 0.0) + (e - s)
            for is_, ie in idle:
                ov = min(e, ie) - max(s, is_)
                if ov > 0:
                    exposed[b] = exposed.get(b, 0.0) + ov
    return total_idle, exposed, link_busy


@dataclasses.dataclass(frozen=True)
class SimSpanMetrics:
    """Paper metrics reconstructed purely from spans."""

    n_iterations: int
    warm: int
    iteration_time: float           # steady-state seconds/iteration
    compute_time: float             # F+B seconds of one iteration
    bubble_fraction: float          # (iter - compute) / iter
    coverage_rate: float            # workload CR: sum_b comm_b / compute
    effective_coverage_rate: float  # transmitted (volume-reduced) CR
    per_bucket_comm: Dict[int, float]       # nominal grad-sync seconds
    per_bucket_bubble: Dict[int, float]     # exposed s/iter by bucket
    total_idle_per_iter: float
    link_busy_per_iter: Dict[int, float]    # wall busy s/iter by link
    # split item model (§12): nominal all-gather seconds per bucket
    # (empty for fused-chain timelines)
    per_bucket_ag: Dict[int, float] = dataclasses.field(default_factory=dict)


def sim_metrics_from_spans(
    spans: Sequence[Span],
    *,
    mu: float = 1.0,
    warm: Optional[int] = None,
) -> SimSpanMetrics:
    """Reproduce the simulator's steady-state numbers from spans alone.

    ``warm`` defaults to the DeFT convention ``max(2, n // 4)``; pass
    ``2`` for baseline-policy spans.  ``mu`` converts secondary-link
    wall time back to nominal (primary-link) comm seconds.
    """
    steps = sorted((sp for sp in spans if sp.kind == "step"),
                   key=lambda sp: sp.t0)
    if len(steps) < 3:
        raise ValueError("need at least 3 step spans for steady state")
    n = len(steps)
    if warm is None:
        warm = max(2, n // 4)
    # identical arithmetic to simulate_deft: (t_end - start_warm) / count
    iteration_time = (steps[-1].t1 - steps[warm].t0) / max(n - warm, 1)

    # compute seconds of one iteration, bucket-ascending F then B (the
    # summation order BucketTimes.fwd_total + bwd_total uses)
    comp = [sp for sp in spans
            if sp.kind == "compute" and sp.step == steps[warm].step]
    fwd = sorted((sp for sp in comp if sp.args["op"] == "F"),
                 key=lambda sp: sp.args["bucket"])
    bwd = sorted((sp for sp in comp if sp.args["op"] == "B"),
                 key=lambda sp: sp.args["bucket"])
    compute = (sum(sp.duration for sp in fwd)
               + sum(sp.duration for sp in bwd))

    # nominal per-bucket comm: any occurrence (merging never grows the
    # tensor, so every transmission of bucket b has the same nominal
    # cost); AG items (§12) are tracked separately — they price forward
    # streaming, not the grad-sync knapsack
    per_bucket_comm: Dict[int, float] = {}
    per_bucket_ag: Dict[int, float] = {}
    for sp in spans:
        if sp.kind != "collective":
            continue
        args = sp.args
        b = int(args["bucket"])
        nominal = sp.duration / (mu if int(args.get("link", 0)) else 1.0)
        if args.get("op") == "ag":
            per_bucket_ag.setdefault(b, nominal)
        else:
            per_bucket_comm.setdefault(b, nominal)

    t_a, t_b = steps[warm].t0, steps[-1].t1
    iters = max(n - warm, 1)
    total_idle, exposed, link_busy = timeline_bubbles(spans, t_a, t_b)

    transmitted = 0.0
    for sp in spans:
        if sp.kind != "collective":
            continue
        for s, e in _clip([(sp.t0, sp.t1)], t_a, t_b):
            link = int(sp.args.get("link", 0))
            transmitted += (e - s) / (mu if link else 1.0)

    comm_total = sum(per_bucket_comm.values())
    return SimSpanMetrics(
        n_iterations=n,
        warm=warm,
        iteration_time=iteration_time,
        compute_time=compute,
        bubble_fraction=max(0.0, 1.0 - compute / iteration_time),
        coverage_rate=comm_total / max(compute, 1e-12),
        effective_coverage_rate=(transmitted / iters) / max(compute, 1e-12),
        per_bucket_comm=per_bucket_comm,
        per_bucket_bubble={b: v / iters for b, v in sorted(exposed.items())},
        total_idle_per_iter=total_idle / iters,
        link_busy_per_iter={k: v / iters for k, v in sorted(link_busy.items())},
        per_bucket_ag=per_bucket_ag,
    )


# ---------------------------------------------------------------------------
# live path: measured per-phase durations -> paper metrics
# ---------------------------------------------------------------------------

def latest_phase_durations(
    samples: Sequence, period: int
) -> List[Optional[float]]:
    """Most recent wall seconds per cycle phase from a sample trail
    (``Telemetry.samples()``).  No smoothing — this is the raw signal
    whose divergence leads the EMA by design."""
    out: List[Optional[float]] = [None] * period
    for s in samples:
        if 0 <= s.phase < period:
            out[s.phase] = s.wall_s
    return out


def phase_divergence(
    planned: Sequence[float], measured: Sequence[Optional[float]]
) -> Tuple[Optional[float], ...]:
    """Signed relative (measured - planned) / planned per phase."""
    out: List[Optional[float]] = []
    for p, m in zip(planned, measured):
        out.append(None if m is None else (m - p) / max(p, 1e-12))
    return tuple(out)


def bucket_divergence(
    schedule: DeftSchedule,
    divergence: Sequence[Optional[float]],
    ag_plan=None,
) -> Dict[int, float]:
    """Mean per-phase divergence over the phases in which each bucket
    communicates — 'which bucket's communication slipped' at cycle
    resolution.  Under the split item model (§12) a bucket participates
    both in the phases where its grad-sync item lands AND in the phases
    where ``ag_plan`` streams its all-gather item."""
    n = len(schedule.phases[0].route_new)
    ag_phases = set()
    if ag_plan is not None:
        ag_phases = {(i.bucket, i.phase) for i in ag_plan.items}
    out: Dict[int, float] = {}
    for b in range(n):
        ds = [
            d
            for t, (ph, d) in enumerate(zip(schedule.phases, divergence))
            if d is not None
            and (ph.sync_cur[b] or ph.route_new[b] == "sync"
                 or (b, t) in ag_phases)
        ]
        if ds:
            out[b] = sum(ds) / len(ds)
    return out


@dataclasses.dataclass(frozen=True)
class Attribution:
    """The live report: paper metrics measured against the plan."""

    period: int
    planned_cr: float
    measured_cr: float               # CR at the calibrated scales
    comp_scale: float
    comm_scale: float
    residual: float                  # rms calibration residual, seconds
    planned_phase_s: Tuple[float, ...]
    measured_phase_s: Tuple[Optional[float], ...]
    divergence: Tuple[Optional[float], ...]      # per phase, signed
    per_bucket_divergence: Dict[int, float]
    iteration_time: float            # simulated at calibrated scales
    bubble_fraction: float
    per_bucket_bubble: Dict[int, float]          # exposed s/iter
    capacity_utilization: Dict[str, float]       # knapsack fill per link

    @property
    def max_divergence(self) -> float:
        """Largest absolute per-phase divergence (0 when unmeasured)."""
        return max((abs(d) for d in self.divergence if d is not None),
                   default=0.0)

    @property
    def cr_error(self) -> float:
        """Relative measured-vs-planned coverage-rate error."""
        return abs(self.measured_cr - self.planned_cr) / max(
            self.planned_cr, 1e-12
        )


def attribute(
    measured: Sequence[Optional[float]],
    times: BucketTimes,
    scfg: SchedulerConfig,
    schedule: DeftSchedule,
    ag_plan=None,
) -> Attribution:
    """Align measured per-phase durations against the plan.

    ``measured[p]`` is the observed wall seconds of cycle phase ``p``
    (EMA or latest-sample; ``None`` where unobserved); ``times``/``scfg``
    are the *planned* profile the installed ``schedule`` was solved
    from.  Fits the calibration scales, then re-runs the timeline
    simulator at those scales to express the measurement in the paper's
    metrics.

    Decoupled plans (§12) pass their ``AgStreamPlan``: the calibrated
    re-simulation then streams the AG items (stall semantics) and the
    per-bucket divergence attributes slip to AG phases as well — with
    ``times`` being the RS-side profile the schedule was solved on.
    """
    period = schedule.period
    planned = planned_phase_durations(times, scfg, period)
    div = phase_divergence(planned, measured)
    a, b, resid = fit_scales(times, scfg, period, measured)
    run_times = scale_times(times, a, b)

    ag_kw = {}
    if ag_plan is not None and ag_plan.items:
        durs = [0.0] * times.n
        links_ = [0] * times.n
        t0 = ag_plan.items[0].phase
        for item in ag_plan.items_for_phase(t0):
            durs[item.bucket] = item.duration * b   # comm-scale calibrated
            links_[item.bucket] = item.link
        ag_kw = dict(ag_times=tuple(durs), ag_links=tuple(links_))
    plans = schedule_plans(times, scfg, horizon=fit_horizon(period))
    sim = simulate_deft(
        run_times, plans, mu=scfg.mu,
        heterogeneous=scfg.heterogeneous, keep_timeline=True,
        link_models=scfg.link_models, **ag_kw,
    )
    # with per-link LinkModels (§14) the wall-to-nominal conversion for
    # secondary spans uses the models' bandwidth ratio, not the scalar mu
    mu_eff = (effective_mu(scfg.models())
              if scfg.link_models is not None else scfg.mu)
    m = sim_metrics_from_spans(
        spans_from_sim(sim), mu=mu_eff, warm=max(2, len(plans) // 4)
    )

    # knapsack capacities per iteration (scheduler._caps semantics, in
    # nominal comm seconds): primary gets compute * capacity_factor,
    # secondary the same over mu; utilization = nominal comm scheduled
    # into the window / capacity.
    cap_p = m.compute_time * scfg.capacity_factor
    util: Dict[str, float] = {}
    if cap_p > 0:
        busy0 = m.link_busy_per_iter.get(0, 0.0)
        util["link0"] = busy0 / cap_p
        if scfg.heterogeneous:
            busy1 = m.link_busy_per_iter.get(1, 0.0) / max(mu_eff, 1e-12)
            util["link1"] = busy1 / (cap_p / mu_eff)

    return Attribution(
        period=period,
        planned_cr=times.coverage_rate,
        measured_cr=run_times.coverage_rate,
        comp_scale=a,
        comm_scale=b,
        residual=resid,
        planned_phase_s=planned,
        measured_phase_s=tuple(measured[:period]),
        divergence=div,
        per_bucket_divergence=bucket_divergence(schedule, div,
                                                ag_plan=ag_plan),
        iteration_time=m.iteration_time,
        bubble_fraction=m.bubble_fraction,
        per_bucket_bubble=m.per_bucket_bubble,
        capacity_utilization=util,
    )


def measured_phase_durations_from_trace(
    tracer: Tracer, period: int
) -> List[Optional[float]]:
    """Mean per-cycle-phase duration of recorded ``phase`` spans,
    excluding first-dispatch spans (``first`` tag — compile pollution)."""
    acc: Dict[int, List[float]] = {}
    for sp in tracer.spans("phase"):
        if sp.phase is None or not 0 <= sp.phase < period:
            continue
        if sp.args.get("first"):
            continue
        acc.setdefault(sp.phase, []).append(sp.duration)
    return [
        (sum(acc[p]) / len(acc[p])) if acc.get(p) else None
        for p in range(period)
    ]


def attribute_trace(
    tracer: Tracer,
    times: BucketTimes,
    scfg: SchedulerConfig,
    schedule: DeftSchedule,
) -> Attribution:
    """:func:`attribute` over the ``phase`` spans in a live trace."""
    measured = measured_phase_durations_from_trace(tracer, schedule.period)
    return attribute(measured, times, scfg, schedule)


# ---------------------------------------------------------------------------
# wire-byte attribution (§13): did the wire carry the bytes the plan priced?
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WireBytesReport:
    """Measured-vs-planned bytes on the wire per cycle phase.

    ``planned_per_phase`` is what the *current* plan prices (layout
    precision applied to each phase's synced buckets);
    ``measured_per_phase`` is what the executed collectives actually
    shipped, read back from the runtime's ``collective-group`` spans.
    The two diverge exactly when execution lags the plan — e.g. steps
    that ran on a stale layout while a precision hot-swap compiled —
    so ``ok`` is the end-to-end check that the policy the knapsack
    priced is the policy the wire carried.
    """

    period: int
    planned_per_phase: Tuple[int, ...]
    measured_per_phase: Tuple[Optional[float], ...]  # mean over cycles
    precisions: Tuple[Optional[str], ...]            # span wire tags
    # per-link split (§14): (primary, secondary) bytes per phase — did
    # the traffic the knapsack placed on each link actually ride it?
    # None when the runtime predates per-link spans or no split was
    # requested; unobserved phases are None entries in measured_split.
    planned_split: Optional[Tuple[Tuple[int, int], ...]] = None
    measured_split: Optional[
        Tuple[Optional[Tuple[float, float]], ...]
    ] = None

    @property
    def planned_per_cycle(self) -> int:
        return sum(self.planned_per_phase)

    @property
    def measured_per_cycle(self) -> float:
        """Observed bytes per cycle (unobserved phases assume plan)."""
        return sum(
            m if m is not None else float(p)
            for m, p in zip(self.measured_per_phase, self.planned_per_phase)
        )

    @property
    def max_abs_error(self) -> float:
        """Largest absolute measured-planned byte gap over phases."""
        return max(
            (abs(m - p) for m, p in
             zip(self.measured_per_phase, self.planned_per_phase)
             if m is not None),
            default=0.0,
        )

    @property
    def max_abs_split_error(self) -> float:
        """Largest per-link |measured - planned| byte gap over observed
        phases; 0 when no split was recorded."""
        if self.planned_split is None or self.measured_split is None:
            return 0.0
        return max(
            (max(abs(m[0] - p[0]), abs(m[1] - p[1]))
             for m, p in zip(self.measured_split, self.planned_split)
             if m is not None),
            default=0.0,
        )

    @property
    def ok(self) -> bool:
        """Every observed phase shipped exactly the planned bytes —
        in total AND per link when a split is recorded."""
        return self.max_abs_error == 0.0 and self.max_abs_split_error == 0.0


def wire_bytes_from_trace(
    tracer: Tracer, period: int
) -> Tuple[List[Optional[float]], List[Optional[str]]]:
    """Mean ``wire_bytes`` (and the wire tag) of the recorded
    ``collective-group`` spans per cycle phase.  First-dispatch spans
    are NOT excluded — byte counts are exact regardless of compile
    pollution; only durations need the ``first`` filter."""
    acc: Dict[int, List[float]] = {}
    tags: Dict[int, str] = {}
    for sp in tracer.spans("collective-group"):
        if sp.phase is None or not 0 <= sp.phase < period:
            continue
        wb = sp.args.get("wire_bytes")
        if wb is None:
            continue
        acc.setdefault(sp.phase, []).append(float(wb))
        tag = sp.args.get("precision")
        if tag is not None:
            tags[sp.phase] = tag
    measured = [
        (sum(acc[p]) / len(acc[p])) if acc.get(p) else None
        for p in range(period)
    ]
    return measured, [tags.get(p) for p in range(period)]


def link_wire_bytes_from_trace(
    tracer: Tracer, period: int
) -> List[Optional[Tuple[float, float]]]:
    """Mean (primary, secondary) wire bytes of the recorded
    ``collective-group`` spans per cycle phase (§14).  ``None`` for
    phases with no spans or spans from a runtime that predates the
    per-link attrs."""
    acc: Dict[int, List[Tuple[float, float]]] = {}
    for sp in tracer.spans("collective-group"):
        if sp.phase is None or not 0 <= sp.phase < period:
            continue
        wp = sp.args.get("wire_bytes_primary")
        ws = sp.args.get("wire_bytes_secondary")
        if wp is None or ws is None:
            continue
        acc.setdefault(sp.phase, []).append((float(wp), float(ws)))
    out: List[Optional[Tuple[float, float]]] = []
    for p in range(period):
        pairs = acc.get(p)
        if not pairs:
            out.append(None)
        else:
            out.append((
                sum(x for x, _ in pairs) / len(pairs),
                sum(y for _, y in pairs) / len(pairs),
            ))
    return out


def wire_bytes_report(
    tracer: Tracer,
    planned_per_phase: Sequence[int],
    planned_split: Optional[Sequence[Tuple[int, int]]] = None,
) -> WireBytesReport:
    """Compare a live trace's shipped bytes against the plan's pricing
    (``planned_per_phase`` — the runtime's per-phase wire-byte vector,
    ``DeftRuntime._wire_bytes_of_step``-shaped: one entry per cycle
    phase under the installed layout's precision).  Pass the runtime's
    ``wire_bytes_split_per_phase`` as ``planned_split`` to also check
    the per-link (primary, secondary) attribution (§14)."""
    period = len(planned_per_phase)
    measured, tags = wire_bytes_from_trace(tracer, period)
    m_split = (
        tuple(link_wire_bytes_from_trace(tracer, period))
        if planned_split is not None else None
    )
    return WireBytesReport(
        period=period,
        planned_per_phase=tuple(int(b) for b in planned_per_phase),
        measured_per_phase=tuple(measured),
        precisions=tuple(tags),
        planned_split=(
            tuple((int(p), int(s)) for p, s in planned_split)
            if planned_split is not None else None
        ),
        measured_split=m_split,
    )
