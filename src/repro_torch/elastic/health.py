"""Failure detection for the elastic control plane (DESIGN.md §10).

The adaptive loop (adapt/) answers "is the *plan* still right for the
hardware"; this module answers "is the *hardware* still there".  The
:class:`HealthMonitor` consumes one per-shard observation per training
step — wall seconds (or ``None`` for a missed heartbeat) plus optional
collective-phase seconds — and emits :class:`FaultEvent`\\ s under three
configurable policies:

* **absolute timeout** (dead/preempted device): a shard silent for
  longer than ``max(timeout_min_s, timeout_factor x median step EMA)``
  is declared ``dead``.  The clock is injected, never sampled, so fault
  scenarios replay bit-for-bit.
* **relative EWMA** (straggler): a shard whose step-time EMA exceeds
  ``straggler_ratio x`` the median of its live peers for
  ``straggler_patience`` consecutive observations is a ``straggler``;
  dropping back under ``recovered_ratio`` for ``recovered_patience``
  observations emits ``recovered``.
* **explicit preemption notice** (:meth:`notice_preemption`): cluster
  managers say goodbye before killing; the notice marks the shard
  ``preempted`` immediately — no timeout wait.

A *uniform* slowdown (every shard's collective EMA rising together) is
deliberately NOT a fault: that is bandwidth drift, the adaptive
replanner's job, and the monitor reports it as an informational
``bandwidth`` event exactly once per excursion so the caller can route
it there.  The straggler policy is ratio-against-median, so it stays
quiet under uniform degradation by construction.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.adapt.telemetry import ShardTelemetry, TelemetryConfig
from repro_torch.obs.trace import Tracer


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Detection thresholds (DESIGN.md §10 documents the choices)."""

    # per-shard EWMA smoothing (ShardTelemetry)
    ema_alpha: float = 0.25
    warmup_steps: int = 3
    # straggler policy: shard EMA vs median of live peers
    straggler_ratio: float = 1.75
    straggler_patience: int = 3
    recovered_ratio: float = 1.2
    recovered_patience: int = 3
    # dead-device policy: absolute heartbeat timeout
    timeout_factor: float = 8.0      # x median step EMA
    timeout_min_s: float = 0.0       # absolute floor (0 = purely relative)
    # uniform collective-latency drift reported as 'bandwidth' (info only)
    bandwidth_ratio: float = 1.75


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One detected health transition."""

    step: int
    kind: str        # 'dead' | 'straggler' | 'preemption' | 'recovered'
    #                # | 'bandwidth'
    shard: int       # -1 for shard-less events (bandwidth)
    metric: float = 0.0   # the ratio / silence seconds that triggered it
    detail: str = ""

    def describe(self) -> str:
        who = f"shard {self.shard}" if self.shard >= 0 else "all shards"
        return (f"step {self.step:5d}  {self.kind:<10s} {who} "
                f"(metric {self.metric:.2f}){' ' + self.detail if self.detail else ''}")


class HealthMonitor:
    """Per-shard health state machine over :class:`ShardTelemetry`.

    Shard status: ``healthy`` -> ``straggler`` (recoverable) -> back, or
    ``healthy``/``straggler`` -> ``dead``/``preempted`` (terminal until
    :meth:`reset`, which the coordinator calls after a mesh change).
    Every transition fires exactly one :class:`FaultEvent`.
    """

    def __init__(
        self,
        n_shards: int,
        cfg: Optional[HealthConfig] = None,
        tracer: Optional[Tracer] = None,
    ):
        self.cfg = cfg or HealthConfig()
        # detection events mirror into the shared trace (DESIGN.md §11);
        # timestamps come from the TRACER's clock so one trace stays in
        # one clock domain — the monitor's replay clock rides as an attr
        self.tracer = tracer
        self.telemetry = ShardTelemetry(
            n_shards,
            TelemetryConfig(
                ema_alpha=self.cfg.ema_alpha,
                warmup_steps=self.cfg.warmup_steps,
            ),
        )
        self.events: List[FaultEvent] = []
        self.reset(n_shards)

    def _emit(self, ev: FaultEvent) -> None:
        if self.tracer is not None:
            self.tracer.instant(
                "elastic", f"detect-{ev.kind}", step=ev.step,
                shard=ev.shard, metric=ev.metric,
                monitor_clock=self._clock,
            )

    # ---- lifecycle ------------------------------------------------------
    def reset(self, n_shards: int, now: Optional[float] = None) -> None:
        """Re-arm for a new shard set (after an elastic mesh change).
        The event trail survives; all telemetry and status are fresh.

        The clock is CONTINUOUS across resets (``now`` overrides it),
        and every shard gets a liveness stamp at the reset instant — so
        a shard that never heartbeats after the mesh change (e.g. a
        returnee that fails to actually come back) accumulates silence
        from the reset and is declared dead, instead of being skipped
        forever on ``last_seen is None``."""
        self.n_shards = n_shards
        self.telemetry.rebase(n_shards)
        self.status: List[str] = ["healthy"] * n_shards
        self._slow_streak = [0] * n_shards
        self._ok_streak = [0] * n_shards
        self._clock = now if now is not None else getattr(self, "_clock", 0.0)
        for i in range(n_shards):
            self.telemetry.heartbeat(i, self._clock)
        self._bandwidth_flagged = False
        self._coll_baseline: Optional[float] = None

    # ---- explicit inputs ------------------------------------------------
    def notice_preemption(
        self, step: int, shard: int, detail: str = ""
    ) -> Optional[FaultEvent]:
        """Cluster-manager preemption notice: ``shard`` will die soon.
        Marks it terminally unhealthy NOW (no timeout wait).  Returns the
        event, or None if the shard was already dead/preempted."""
        if self.status[shard] in ("dead", "preempted"):
            return None
        self.status[shard] = "preempted"
        ev = FaultEvent(step, "preemption", shard, detail=detail)
        self.events.append(ev)
        self._emit(ev)
        return ev

    # ---- the per-step hook ----------------------------------------------
    def observe(
        self,
        step: int,
        walls: Sequence[Optional[float]],
        collectives: Optional[Sequence[Optional[float]]] = None,
        now: Optional[float] = None,
    ) -> List[FaultEvent]:
        """Feed one step's per-shard observations; returns the fault
        events this step triggered (usually none).

        ``walls[i]`` is shard ``i``'s step wall seconds, or ``None`` for
        a missed heartbeat.  ``now`` is the monotonic clock; when omitted
        the monitor advances an internal clock by the slowest observed
        wall (the step's critical path), which keeps synthetic replays
        free of real timestamps."""
        if len(walls) != self.n_shards:
            raise ValueError(
                f"expected {self.n_shards} shard observations, got {len(walls)}"
            )
        live_walls = [w for w in walls if w is not None]
        if now is None:
            self._clock += max(live_walls, default=0.0)
            now = self._clock
        else:
            self._clock = now
        for i, w in enumerate(walls):
            if w is None:
                continue
            c = collectives[i] if collectives is not None else None
            self.telemetry.record(i, w, collective_s=c, now=now)

        out: List[FaultEvent] = []
        alive = self.alive_shards()
        med = self.telemetry.median_step_time(alive)

        # -- absolute-timeout policy: dead devices ------------------------
        timeout = self.cfg.timeout_min_s
        if med is not None:
            timeout = max(timeout, self.cfg.timeout_factor * med)
        if timeout > 0:
            for i in alive:
                seen = self.telemetry.last_seen(i)
                if seen is None:       # unreachable: reset() stamps all
                    continue
                silence = now - seen
                if silence > timeout:
                    self.status[i] = "dead"
                    out.append(FaultEvent(
                        step, "dead", i, metric=silence,
                        detail=f"silent {silence:.2f}s > timeout {timeout:.2f}s",
                    ))

        # -- relative EWMA policy: stragglers -----------------------------
        alive = self.alive_shards()
        med = self.telemetry.median_step_time(alive)
        if med is not None and med > 0 and len(alive) >= 2:
            for i in alive:
                t = self.telemetry.step_time(i)
                if t is None:
                    continue
                ratio = t / med
                if self.status[i] == "healthy":
                    if ratio > self.cfg.straggler_ratio:
                        self._slow_streak[i] += 1
                        if self._slow_streak[i] >= self.cfg.straggler_patience:
                            self.status[i] = "straggler"
                            self._ok_streak[i] = 0
                            out.append(FaultEvent(
                                step, "straggler", i, metric=ratio,
                                detail=f"{ratio:.2f}x median",
                            ))
                    else:
                        self._slow_streak[i] = 0
                elif self.status[i] == "straggler":
                    if ratio < self.cfg.recovered_ratio:
                        self._ok_streak[i] += 1
                        if self._ok_streak[i] >= self.cfg.recovered_patience:
                            self.status[i] = "healthy"
                            self._slow_streak[i] = 0
                            out.append(FaultEvent(
                                step, "recovered", i, metric=ratio,
                            ))
                    else:
                        self._ok_streak[i] = 0

        # -- uniform collective drift: informational ----------------------
        coll = self.telemetry.median_collective_time(self.alive_shards())
        if coll is not None:
            if self._coll_baseline is None:
                self._coll_baseline = coll
            ratio = coll / max(self._coll_baseline, 1e-12)
            if ratio > self.cfg.bandwidth_ratio and not self._bandwidth_flagged:
                self._bandwidth_flagged = True
                out.append(FaultEvent(
                    step, "bandwidth", -1, metric=ratio,
                    detail="uniform collective-latency drift — route to "
                           "the adaptive replanner, not a mesh change",
                ))
            elif ratio <= self.cfg.recovered_ratio:
                self._bandwidth_flagged = False

        self.events.extend(out)
        for ev in out:
            self._emit(ev)
        return out

    # ---- queries --------------------------------------------------------
    def alive_shards(self) -> List[int]:
        """Shards still usable for collectives (healthy or straggling —
        a straggler is slow, not gone)."""
        return [
            i for i, s in enumerate(self.status)
            if s in ("healthy", "straggler")
        ]

    def healthy_shards(self) -> List[int]:
        return [i for i, s in enumerate(self.status) if s == "healthy"]

    def stats(self) -> dict:
        return {
            "n_shards": self.n_shards,
            "status": list(self.status),
            "events": [dataclasses.asdict(e) for e in self.events],
            "step_ema": [
                self.telemetry.step_time(i) for i in range(self.n_shards)
            ],
            "collective_ema": [
                self.telemetry.collective_time(i)
                for i in range(self.n_shards)
            ],
        }
