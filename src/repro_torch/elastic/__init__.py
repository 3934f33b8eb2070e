"""Fault-tolerant elastic control plane of the port (DESIGN.md §10).

The adaptive loop (repro_torch.adapt) re-plans when the hardware gets
*slower*; this layer re-plans when the hardware gets *smaller*: per-shard
health monitoring detects stragglers and dead/preempted ranks, an
:class:`ElasticController` prices the surviving group through the same
calibrated ``LeafTimeModel`` / :meth:`~repro_torch.core.deft.Planner.plan`
(candidate grid) / Preserver path, and the :class:`ElasticCoordinator`
executes the cycle-boundary scale-down (and symmetric scale-up) over a
process group of the survivors with zero restart.  Every recovery path
replays deterministically through :class:`FaultScenario`.  ``health``,
``faults`` and ``controller`` are the JAX package's modules; the
coordinator is re-implemented over ``torch.distributed``.
"""
from repro_torch.elastic.controller import (
    ElasticConfig,
    ElasticController,
    ElasticPlan,
)
from repro_torch.elastic.coordinator import (
    ElasticCoordinator,
    ElasticHalt,
    fold_accum_rows,
    migrate_state,
)
from repro_torch.elastic.faults import (
    BandwidthCollapse,
    CapacityReturn,
    DeviceDrop,
    FaultScenario,
    KillMidCheckpoint,
    PreemptionNotice,
    ShardObservation,
    StragglerSlowdown,
    truncate_checkpoint,
)
from repro_torch.elastic.health import FaultEvent, HealthConfig, HealthMonitor

__all__ = [
    "BandwidthCollapse",
    "CapacityReturn",
    "DeviceDrop",
    "ElasticConfig",
    "ElasticController",
    "ElasticCoordinator",
    "ElasticHalt",
    "ElasticPlan",
    "FaultEvent",
    "FaultScenario",
    "HealthConfig",
    "HealthMonitor",
    "KillMidCheckpoint",
    "PreemptionNotice",
    "ShardObservation",
    "StragglerSlowdown",
    "fold_accum_rows",
    "migrate_state",
    "truncate_checkpoint",
]
