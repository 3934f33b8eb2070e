"""Online adaptive control plane: telemetry -> calibration -> drift
detection -> Preserver-gated replanning -> DeftRuntime hot-swap.

Closes the paper's Fig. 7 feedback loop *during* training instead of only
before step 0: measured per-phase wall times re-base the analytical
profile, the Solver re-plans off the hot path, and the runtime swaps the
compiled phase set at a period boundary (DESIGN.md §7).
"""
from repro_torch.adapt.calibrate import (
    CalibratedProfile,
    calibrate,
    fit_scales,
    fit_secondary_scale,
    scale_times,
    schedule_plans,
    steady_phase_durations,
)
from repro_torch.adapt.controller import AdaptConfig, AdaptiveController, ReplanEvent
from repro_torch.adapt.repartition import (
    PartitionCandidate,
    RepartitionConfig,
    Repartitioner,
    candidate_solve_table,
    dp_partition,
    exposed_makespan,
)
from repro_torch.adapt.scenario import (
    BandwidthDrop,
    SyntheticTelemetrySource,
    run_control_loop,
)
from repro_torch.adapt.telemetry import (
    ShardTelemetry,
    StepSample,
    Telemetry,
    TelemetryConfig,
)

__all__ = [
    "AdaptConfig",
    "AdaptiveController",
    "BandwidthDrop",
    "CalibratedProfile",
    "PartitionCandidate",
    "RepartitionConfig",
    "Repartitioner",
    "ReplanEvent",
    "ShardTelemetry",
    "StepSample",
    "SyntheticTelemetrySource",
    "Telemetry",
    "TelemetryConfig",
    "candidate_solve_table",
    "calibrate",
    "dp_partition",
    "exposed_makespan",
    "fit_scales",
    "fit_secondary_scale",
    "run_control_loop",
    "scale_times",
    "schedule_plans",
    "steady_phase_durations",
]
