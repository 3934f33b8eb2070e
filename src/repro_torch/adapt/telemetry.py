"""Runtime telemetry for the online adaptive control plane (DESIGN.md §7).

The paper closes its Fig. 7 loop with "convergence loss quantification"
collected from the *running* job; our analogue is a small, allocation-free
store the train loop feeds after every :meth:`DeftRuntime.step`:

* a **ring buffer** of per-step samples (step id, phase-in-cycle, wall
  seconds, loss) bounded by ``ring_size`` — the control plane never holds
  more than a constant amount of history;
* **per-phase EMA** of wall time, keyed by the phase's position in the
  installed schedule's cycle — this is what calibration compares against
  the planned per-phase durations;
* **warm-up skip** — the first ``warmup_steps`` samples after a (re)start
  are recorded in the ring but excluded from the EMAs, so compile jitter
  and cold caches right after start or a hot-swap never read as drift.

The store is schedule-relative: after a hot-swap the runtime's cycle and
period change, so :meth:`rebase` re-keys the per-phase EMAs (and re-arms
the warm-up) while keeping the loss trace, which is schedule-independent.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, List, Optional


@dataclasses.dataclass(frozen=True)
class StepSample:
    """One observed training step."""

    step: int
    phase: int              # position in the installed schedule's cycle
    wall_s: float
    loss: Optional[float] = None
    updated: bool = False


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    ring_size: int = 256
    ema_alpha: float = 0.25     # weight of the newest sample
    warmup_steps: int = 8       # samples skipped after (re)start / rebase


class Telemetry:
    """Ring-buffer store with per-phase EMA smoothing and warm-up skip."""

    def __init__(self, n_phases: int, cfg: Optional[TelemetryConfig] = None):
        self.cfg = cfg or TelemetryConfig()
        self._ring: Deque[StepSample] = collections.deque(
            maxlen=self.cfg.ring_size
        )
        self._losses: Deque[float] = collections.deque(
            maxlen=self.cfg.ring_size
        )
        self.n_recorded = 0
        self.rebase(n_phases)

    # ---- lifecycle ------------------------------------------------------
    def rebase(self, n_phases: int, extra_warmup: int = 0) -> None:
        """Re-key the per-phase EMAs for a new schedule (hot-swap) and
        re-arm the warm-up skip.  The loss trace survives — convergence is
        a property of training, not of the schedule.

        ``extra_warmup`` widens the re-armed skip: the controller rebases
        at *replan* time, but the runtime installs the new schedule up to
        one old period later, so the old schedule's tail steps (recorded
        under the new schedule's phase keys) must also fall inside the
        warm-up window or they would pollute the fresh EMAs."""
        self.n_phases = n_phases
        self._ema: List[Optional[float]] = [None] * n_phases
        self._ema_n: List[int] = [0] * n_phases
        self._since_rebase = -max(extra_warmup, 0)

    # ---- recording ------------------------------------------------------
    def record(
        self,
        step: int,
        phase: int,
        wall_s: float,
        loss: Optional[float] = None,
        updated: bool = False,
        cold: Optional[bool] = None,
    ) -> StepSample:
        """``cold`` is the runtime's first-dispatch tag (DESIGN.md §11):
        ``True`` means this wall time includes an executable's one-off
        lazy work and must never enter the EMAs.  When the tag is
        available (not ``None``) it REPLACES the fixed ``warmup_steps``
        count — warm samples enter the EMAs immediately — while the
        rebase ``extra_warmup`` window (``_since_rebase <= 0``) still
        guards the old schedule's tail steps after a hot-swap.  With
        ``cold=None`` (no tag) the legacy fixed-count skip applies."""
        sample = StepSample(step, phase, wall_s, loss, updated)
        self._ring.append(sample)
        self.n_recorded += 1
        if loss is not None:
            self._losses.append(float(loss))
        self._since_rebase += 1
        if cold is True:
            return sample                      # first-dispatch pollution
        if cold is None:
            if self._since_rebase <= self.cfg.warmup_steps:
                return sample                  # warm-up skip (fixed count)
        elif self._since_rebase <= 0:
            return sample                      # post-rebase tail window
        if 0 <= phase < self.n_phases:
            prev = self._ema[phase]
            a = self.cfg.ema_alpha
            self._ema[phase] = (
                wall_s if prev is None else a * wall_s + (1.0 - a) * prev
            )
            self._ema_n[phase] += 1
        return sample

    # ---- queries --------------------------------------------------------
    def phase_time(self, phase: int) -> Optional[float]:
        """EMA wall seconds of one phase; None until it has a sample."""
        return self._ema[phase]

    def phase_times(self) -> List[Optional[float]]:
        return list(self._ema)

    def phase_samples(self, phase: int) -> int:
        return self._ema_n[phase]

    def ready(self, min_per_phase: int = 1) -> bool:
        """Every phase of the cycle has at least ``min_per_phase``
        post-warm-up samples — calibration would otherwise compare
        against holes."""
        return all(n >= min_per_phase for n in self._ema_n)

    def losses(self, n: Optional[int] = None) -> List[float]:
        xs = list(self._losses)
        return xs if n is None else xs[-n:]

    def samples(self, n: Optional[int] = None) -> List[StepSample]:
        xs = list(self._ring)
        return xs if n is None else xs[-n:]

    def __len__(self) -> int:
        return len(self._ring)


class ShardTelemetry:
    """Per-shard step-time and collective-latency store (DESIGN.md §10).

    :class:`Telemetry` is schedule-relative — it keys EMAs by cycle
    phase and cannot say *which device* is slow.  The elastic health
    monitor instead needs a per-shard view: one EMA of step wall time
    and one of collective latency per data-parallel shard, plus the
    monotonic-clock timestamp of each shard's last heartbeat (the
    absolute-timeout dead-device policy reads it).

    The clock is injected (``now``), never sampled — fault scenarios
    replay deterministically.  ``warmup_steps`` samples per shard are
    heartbeat-only (recorded but excluded from the EMAs) so compile
    jitter after a start or a mesh change never reads as a straggler.
    """

    def __init__(self, n_shards: int, cfg: Optional[TelemetryConfig] = None):
        self.cfg = cfg or TelemetryConfig()
        self.rebase(n_shards)

    # ---- lifecycle ------------------------------------------------------
    def rebase(self, n_shards: int) -> None:
        """Re-key for a new shard count (elastic scale-down/up) and
        re-arm the per-shard warm-up."""
        self.n_shards = n_shards
        self._step_ema: List[Optional[float]] = [None] * n_shards
        self._coll_ema: List[Optional[float]] = [None] * n_shards
        self._n: List[int] = [0] * n_shards
        self._seen: List[int] = [0] * n_shards
        self._last_seen: List[Optional[float]] = [None] * n_shards

    # ---- recording ------------------------------------------------------
    def record(
        self,
        shard: int,
        wall_s: float,
        collective_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> None:
        """One heartbeat from ``shard``: its step wall seconds, optional
        collective-phase seconds, and the monotonic clock it arrived at."""
        if not 0 <= shard < self.n_shards:
            raise IndexError(f"shard {shard} out of range 0..{self.n_shards - 1}")
        if now is not None:
            self._last_seen[shard] = now
        self._seen[shard] += 1
        if self._seen[shard] <= self.cfg.warmup_steps:
            return                                  # warm-up skip
        a = self.cfg.ema_alpha

        def ema(prev: Optional[float], x: float) -> float:
            return x if prev is None else a * x + (1.0 - a) * prev

        self._step_ema[shard] = ema(self._step_ema[shard], wall_s)
        if collective_s is not None:
            self._coll_ema[shard] = ema(self._coll_ema[shard], collective_s)
        self._n[shard] += 1

    def heartbeat(self, shard: int, now: float) -> None:
        """Timestamp-only liveness signal (no timing sample) — a shard
        that is alive but produced no usable measurement this step."""
        self._last_seen[shard] = now

    # ---- queries --------------------------------------------------------
    def step_time(self, shard: int) -> Optional[float]:
        return self._step_ema[shard]

    def collective_time(self, shard: int) -> Optional[float]:
        return self._coll_ema[shard]

    def last_seen(self, shard: int) -> Optional[float]:
        return self._last_seen[shard]

    def samples(self, shard: int) -> int:
        """Post-warm-up samples recorded for ``shard``."""
        return self._n[shard]

    def median_step_time(
        self, shards: Optional[List[int]] = None
    ) -> Optional[float]:
        """Median step-time EMA over ``shards`` (default: all) — the
        straggler policy's 'healthy peer' reference.  A median (not a
        mean) keeps one runaway shard from dragging its own yardstick."""
        idx = range(self.n_shards) if shards is None else shards
        xs = sorted(
            t for i in idx if (t := self._step_ema[i]) is not None
        )
        if not xs:
            return None
        m = len(xs) // 2
        return xs[m] if len(xs) % 2 else 0.5 * (xs[m - 1] + xs[m])

    def median_collective_time(
        self, shards: Optional[List[int]] = None
    ) -> Optional[float]:
        idx = range(self.n_shards) if shards is None else shards
        xs = sorted(
            t for i in idx if (t := self._coll_ema[i]) is not None
        )
        if not xs:
            return None
        m = len(xs) // 2
        return xs[m] if len(xs) % 2 else 0.5 * (xs[m - 1] + xs[m])
