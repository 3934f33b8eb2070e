"""Deterministic telemetry scenarios: what a real deployment would measure.

This container has no cluster whose link can actually degrade, so the
control plane is exercised against *synthetic* telemetry generated by the
same timeline simulator the planner's figures use: per-step wall time =
the steady-state duration of the step's cycle phase when the installed
schedule's plans execute under the scenario's *effective* bucket times.

The canonical scenario is :class:`BandwidthDrop` — "the interconnect gets
``comm_scale`` x slower at step k" (a congested DCN, a flapping NIC, a
mis-modeled HardwareModel discovered at runtime).  Because everything is
pure Python over frozen dataclasses, tests and benchmarks replay the whole
detect -> replan -> hot-swap loop bit-for-bit deterministically.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core.bucket import BucketTimes
from repro_torch.core.scheduler import DeftSchedule, SchedulerConfig
from repro_torch.adapt.calibrate import (
    fit_horizon,
    scale_times,
    schedule_plans,
    steady_phase_durations,
)


@dataclasses.dataclass(frozen=True)
class BandwidthDrop:
    """Effective link bandwidth drops by ``comm_scale`` at ``step`` (comm
    times multiply; > 1 = slower).  ``comp_scale`` covers the analogous
    compute-side mis-model (thermal throttling, MFU estimate off).
    ``end_step`` bounds the excursion (0 = permanent) — a transient
    collapse that recovers, the elastic bench's bandwidth scenario."""

    step: int
    comm_scale: float
    comp_scale: float = 1.0
    end_step: int = 0

    def effective_times(self, base: BucketTimes, step: int) -> BucketTimes:
        if not self.active(step):
            return base
        return scale_times(base, self.comp_scale, self.comm_scale)

    def active(self, step: int) -> bool:
        return step >= self.step and (
            self.end_step == 0 or step < self.end_step
        )


class SyntheticTelemetrySource:
    """Per-step wall-clock oracle for a scenario.

    ``wall_time(step, schedule, scfg, phase)`` returns the steady-state
    duration of cycle phase ``phase`` of the *installed* schedule when its
    plans run under the scenario's effective times at ``step``.  The
    installed schedule changes across hot-swaps; durations are memoized
    per (solver config, degradation regime).
    """

    def __init__(self, base_times: BucketTimes, scenario: BandwidthDrop):
        self.base_times = base_times
        self.scenario = scenario
        self._memo: Dict[Tuple, Tuple[float, ...]] = {}

    def _durations(
        self,
        solve_times: BucketTimes,
        scfg: SchedulerConfig,
        period: int,
        degraded: bool,
        run_base: Optional[BucketTimes],
    ) -> Tuple[float, ...]:
        base = run_base or self.base_times
        key = (
            solve_times.comm,
            solve_times.fwd,
            base.comm,
            base.fwd,
            scfg.heterogeneous,
            scfg.mu,
            scfg.capacity_factor,
            period,
            degraded,
        )
        if key not in self._memo:
            run_times = (
                scale_times(
                    base,
                    self.scenario.comp_scale,
                    self.scenario.comm_scale,
                )
                if degraded
                else base
            )
            plans = schedule_plans(
                solve_times, scfg, horizon=fit_horizon(period)
            )
            self._memo[key] = steady_phase_durations(
                plans, run_times, period,
                mu=scfg.mu, heterogeneous=scfg.heterogeneous,
            )
        return self._memo[key]

    def wall_time(
        self,
        step: int,
        schedule: DeftSchedule,
        scfg: SchedulerConfig,
        phase: int,
        solve_times: Optional[BucketTimes] = None,
        run_base: Optional[BucketTimes] = None,
    ) -> float:
        """Synthetic measured wall seconds for ``step`` running cycle
        phase ``phase`` of ``schedule``.  ``solve_times`` are the bucket
        times the installed schedule was solved from (defaults to the
        scenario's base times — correct for the initial plan);
        ``run_base`` are the scale-1 times the schedule's buckets
        actually RUN at, needed once a repartitioning hot-swap changes
        the bucket granularity away from the scenario's base times."""
        durs = self._durations(
            solve_times or self.base_times,
            scfg,
            schedule.period,
            self.scenario.active(step),
            run_base,
        )
        return durs[phase % schedule.period]


def run_control_loop(
    controller,
    source: SyntheticTelemetrySource,
    steps: int,
    losses=None,
    on_event=None,
    run_base_fn=None,
):
    """Drive a controller against synthetic telemetry for ``steps``,
    modeling the runtime's side of the protocol: the installed schedule
    produces the wall times, an adopted replan changes it, and an actual
    swap restarts the cycle at phase 0.  This is THE reference replay —
    the bench, the explorer and the tests all run through it so the
    phase-advance/adoption rules live in exactly one place.

    ``run_base_fn(event) -> BucketTimes`` supplies the scale-1 run times
    of an adopted partition change (the scenario's base times are bound
    to the ORIGINAL bucket granularity); required only when the
    controller carries a repartitioner.

    Returns ``controller.events``; ``on_event(event)`` fires per event.
    """
    cur_sched = controller.schedule
    cur_scfg = controller.scheduler_cfg
    cur_times = controller.times
    run_base = None
    phase = 0
    for step in range(steps):
        wall = source.wall_time(step, cur_sched, cur_scfg, phase,
                                solve_times=cur_times, run_base=run_base)
        loss = losses[step] if losses is not None else None
        event = controller.observe(step, phase, wall, loss=loss)
        phase = (phase + 1) % cur_sched.period
        if event is not None:
            if on_event is not None:
                on_event(event)
            cur_sched, cur_scfg, cur_times = (
                event.schedule, event.scheduler_cfg, event.times
            )
            if event.partition_changed:
                if run_base_fn is None:
                    raise ValueError(
                        "partition-changing replan in a synthetic replay "
                        "needs run_base_fn (scale-1 times of the new "
                        "partition)"
                    )
                run_base = run_base_fn(event)
            if event.changed:
                phase = 0   # the runtime restarts the cycle at the swap
    return controller.events
