"""DeFT core: the paper's contribution.

Profiler (analytical bucket-time reconstruction) -> Solver (two-stage 0/1
multi-knapsack scheduling, Algorithms 1+2) -> Preserver (Gaussian-walk
convergence check + capacity feedback).  ``plan_deft`` ties them together.
"""
from repro_torch.core.bucket import Bucket, BucketTimes, build_buckets
from repro_torch.core.deft import (
    AgItem,
    AgStreamPlan,
    CandidateSolve,
    DeftPlan,
    Planner,
    PlanRequest,
    PlanResult,
    ag_deadlines,
    ag_times,
    plan_ag_stream,
    plan_deft,
    rs_times,
    solve_schedule,
)
from repro_torch.core.knapsack import (
    deadline_knapsack,
    greedy_multi_knapsack,
    knapsack_two_link,
    naive_knapsack,
    recursive_knapsack,
)
from repro_torch.core.deft import PrecisionSolve
from repro_torch.core.policies import ALL_BASELINES, BaselinePolicy
from repro_torch.core.precision import (
    WIRE_BYTES,
    WIRE_DTYPES,
    PrecisionPolicy,
    apply_wire_precision,
    check_precision_schedule,
    precision_walk,
    wire_bytes_total,
)
from repro_torch.core.preserver import (
    PreserverVerdict,
    WalkParams,
    check_schedule,
    expected_next_state,
    rollout,
)
from repro_torch.core.profiler import HardwareModel, Profile, profile_arch
from repro_torch.core.scheduler import (
    DeftSchedule,
    DeftScheduler,
    IterationPlan,
    PhaseSpec,
    SchedulerConfig,
    Task,
    extract_schedule,
)
from repro_torch.core.simulator import SimResult, simulate_baseline, simulate_deft

__all__ = [
    "Bucket", "BucketTimes", "build_buckets",
    "DeftPlan", "plan_deft", "solve_schedule",
    "Planner", "PlanRequest", "PlanResult", "CandidateSolve",
    "AgItem", "AgStreamPlan", "plan_ag_stream",
    "rs_times", "ag_times", "ag_deadlines",
    "deadline_knapsack",
    "greedy_multi_knapsack", "knapsack_two_link", "naive_knapsack", "recursive_knapsack",
    "ALL_BASELINES", "BaselinePolicy",
    "PrecisionPolicy", "PrecisionSolve", "WIRE_BYTES", "WIRE_DTYPES",
    "apply_wire_precision", "check_precision_schedule", "precision_walk",
    "wire_bytes_total",
    "PreserverVerdict", "WalkParams", "check_schedule", "expected_next_state", "rollout",
    "HardwareModel", "Profile", "profile_arch",
    "DeftSchedule", "DeftScheduler", "IterationPlan", "PhaseSpec",
    "SchedulerConfig", "Task", "extract_schedule",
    "SimResult", "simulate_baseline", "simulate_deft",
]
