"""Deterministic fault injection (DESIGN.md §10).

A :class:`FaultScenario` is a frozen, pure-Python transform from a
*base* per-step observation (whole-job wall seconds + collective
seconds, typically from :class:`repro_torch.adapt.scenario.SyntheticTelemetrySource`
or a constant) to the per-shard observation the
:class:`~repro_torch.elastic.health.HealthMonitor` would have seen under the
injected faults.  Because it is a pure function of the step index, every
recovery path replays bit-for-bit — the chaos tests and
``benchmarks/elastic_bench.py`` drive the identical scenario objects.

Fault types:

* :class:`DeviceDrop` — shards vanish at a step: no heartbeat, ever
  (until a :class:`CapacityReturn` brings them back).
* :class:`StragglerSlowdown` — one shard's wall time multiplies by
  ``factor`` over a step window.
* :class:`BandwidthCollapse` — every shard's collective time multiplies
  by ``comm_scale`` (uniform: a *drift*, not a device fault).
* :class:`PreemptionNotice` — the explicit advance warning a cluster
  manager sends; surfaces in the observation so the driver can forward
  it to :meth:`HealthMonitor.notice_preemption`.
* :class:`CapacityReturn` — previously dropped/preempted shards come
  back (the scale-up trigger).
* :class:`KillMidCheckpoint` — the writer dies mid-save at a step;
  :func:`truncate_checkpoint` applies the damage to the newest
  checkpoint file so resume tests exercise the atomicity guarantees.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DeviceDrop:
    """``shards`` produce no heartbeat from ``step`` on."""

    step: int
    shards: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class StragglerSlowdown:
    """``shard`` runs ``factor``x slower over [step, end_step)
    (``end_step=0`` = forever)."""

    step: int
    shard: int
    factor: float
    end_step: int = 0

    def active(self, step: int) -> bool:
        return step >= self.step and (
            self.end_step == 0 or step < self.end_step
        )


@dataclasses.dataclass(frozen=True)
class BandwidthCollapse:
    """Every shard's collective time multiplies by ``comm_scale`` over
    [step, end_step) — uniform, so the monitor must NOT call it a
    straggler; it surfaces as an informational ``bandwidth`` event."""

    step: int
    comm_scale: float
    end_step: int = 0

    def active(self, step: int) -> bool:
        return step >= self.step and (
            self.end_step == 0 or step < self.end_step
        )


@dataclasses.dataclass(frozen=True)
class PreemptionNotice:
    """The cluster manager announces ``shards`` will be reclaimed."""

    step: int
    shards: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class CapacityReturn:
    """``shards`` (previously dropped or preempted) become usable again."""

    step: int
    shards: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class KillMidCheckpoint:
    """The process dies mid-checkpoint-write at ``step``, leaving
    ``keep_bytes`` of the npz on disk (see :func:`truncate_checkpoint`)."""

    step: int
    keep_bytes: int = 96


@dataclasses.dataclass(frozen=True)
class ShardObservation:
    """What the driver would have measured at one step under the
    scenario — feed ``walls``/``collectives`` to
    :meth:`HealthMonitor.observe`, forward ``notices`` to
    :meth:`notice_preemption` and ``returned`` to the coordinator's
    capacity input."""

    walls: Tuple[Optional[float], ...]
    collectives: Tuple[Optional[float], ...]
    notices: Tuple[int, ...]
    returned: Tuple[int, ...]
    kill_checkpoint: Optional[KillMidCheckpoint]
    comm_scale: float


@dataclasses.dataclass(frozen=True)
class FaultScenario:
    """A replayable fault timeline over ``n_shards`` data-parallel
    shards.  :meth:`observe` is a pure function of the step index and
    the base observation — no clocks, no randomness."""

    n_shards: int
    events: Tuple = ()

    def _of_type(self, t):
        return [e for e in self.events if isinstance(e, t)]

    def dead_at(self, step: int) -> frozenset:
        """Shards with no heartbeat at ``step``: dropped or preempted,
        minus later capacity returns (chronological; the latest event
        for a shard wins)."""
        timeline = []
        for e in self._of_type(DeviceDrop) + self._of_type(PreemptionNotice):
            timeline.append((e.step, "gone", e.shards))
        for e in self._of_type(CapacityReturn):
            timeline.append((e.step, "back", e.shards))
        dead: set = set()
        for at, kind, shards in sorted(timeline, key=lambda x: (x[0], x[1])):
            if at > step:
                continue
            if kind == "gone":
                dead.update(shards)
            else:
                dead.difference_update(shards)
        return frozenset(dead)

    def comm_scale_at(self, step: int) -> float:
        scale = 1.0
        for e in self._of_type(BandwidthCollapse):
            if e.active(step):
                scale *= e.comm_scale
        return scale

    def straggler_factor(self, step: int, shard: int) -> float:
        f = 1.0
        for e in self._of_type(StragglerSlowdown):
            if e.shard == shard and e.active(step):
                f *= e.factor
        return f

    def observe(
        self,
        step: int,
        base_wall: float,
        base_collective: float = 0.0,
    ) -> ShardObservation:
        """Per-shard observation at ``step`` given the healthy-cluster
        base wall/collective seconds.  A dropped shard observes ``None``
        (missed heartbeat); a straggler's wall multiplies; a bandwidth
        collapse adds the extra collective seconds to every live shard's
        wall (a collective is on the critical path of the step)."""
        dead = self.dead_at(step)
        comm_scale = self.comm_scale_at(step)
        extra_comm = base_collective * (comm_scale - 1.0)
        walls = []
        colls = []
        for i in range(self.n_shards):
            if i in dead:
                walls.append(None)
                colls.append(None)
                continue
            walls.append(
                base_wall * self.straggler_factor(step, i) + extra_comm
            )
            colls.append(base_collective * comm_scale)
        notices = tuple(
            s for e in self._of_type(PreemptionNotice)
            if e.step == step for s in e.shards
        )
        returned = tuple(
            s for e in self._of_type(CapacityReturn)
            if e.step == step for s in e.shards
        )
        kill = next(
            (e for e in self._of_type(KillMidCheckpoint) if e.step == step),
            None,
        )
        return ShardObservation(
            walls=tuple(walls),
            collectives=tuple(colls),
            notices=notices,
            returned=returned,
            kill_checkpoint=kill,
            comm_scale=comm_scale,
        )


def truncate_checkpoint(
    directory: str,
    step: int,
    keep_bytes: int = 96,
    *,
    name: str = "ckpt",
) -> str:
    """Apply :class:`KillMidCheckpoint` damage: truncate the step's npz
    to ``keep_bytes`` (a crash mid-write leaves a torn file).  Returns
    the damaged path.  ``checkpoint.latest_step`` must skip the step
    afterwards — that is the atomicity regression test."""
    path = os.path.join(directory, f"{name}_{step:08d}.npz")
    size = os.path.getsize(path)
    with open(path, "rb+") as f:
        f.truncate(min(keep_bytes, size))
    return path
