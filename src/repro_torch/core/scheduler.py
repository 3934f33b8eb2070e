"""DeFT two-stage communication scheduling (paper §III.B, Algorithm 2).

The scheduler is a deterministic state machine over two queues:

* **current task queue** — the unsynchronized tail of the *oldest* gradient
  generation.  When it empties, that generation is fully synchronized and a
  parameter update fires at the end of the iteration.
* **future task queue**  — gradients of newer iterations, merged bucket-wise
  (gradient accumulation) while they wait.

Each training iteration is handled by one of the paper's four cases:

* Case 1 (forward):   schedule current-queue comms into the forward compute
                      time (no data dependencies — plain knapsack /
                      two-link multi-knapsack).
* Case 2 (backward):  backward time cannot cover the current queue — fill
                      it greedily with current-queue comms; the fresh
                      gradients merge into the future queue.
* Case 3 (backward):  backward covers the whole current queue — schedule it
                      all, then fill the remaining capacity from the fresh
                      generation (merged with any future-queue content)
                      using Algorithm 1; leftovers become the new current
                      queue; parameter update fires.
* Case 4 (backward):  current queue already empty — Algorithm 1 directly on
                      the fresh (merged) generation; leftovers become the
                      new current queue; update fires for the previously
                      completed generation.

Running the machine for a fixed horizon yields a cycle; the cycle is the
**periodic schedule** consumed by the simulator, the Preserver (as a
variable-batch-size sequence) and the JAX train loop (as per-step bucket
masks).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.bucket import BucketTimes
from repro_torch.core.knapsack import (
    knapsack_two_link,
    naive_knapsack,
    recursive_knapsack,
)
from repro_torch.core.links import LinkModel


@dataclasses.dataclass(frozen=True)
class Task:
    """A bucket instance awaiting synchronization.

    bucket:  0-based bucket id (0 = input-most, matches paper bucket #1).
    origins: iteration ids whose gradients are merged into this tensor.
             Merging does NOT grow the tensor — that is the paper's whole
             communication-volume reduction.
    """

    bucket: int
    origins: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class IterationPlan:
    """What happens in one training iteration under the schedule."""

    iteration: int
    case: str                              # 'case1+caseK' label for logs
    fwd_primary: Tuple[Task, ...]          # synced during forward, fast link
    fwd_secondary: Tuple[Task, ...]        # synced during forward, slow link
    bwd_primary: Tuple[Task, ...]          # synced during backward, fast link
    bwd_secondary: Tuple[Task, ...]
    new_to_future: bool                    # fresh grads merged into future q
    update: bool
    update_origins: Tuple[int, ...]        # origins applied by the update

    @property
    def synced(self) -> Tuple[Task, ...]:
        return self.fwd_primary + self.fwd_secondary + self.bwd_primary + self.bwd_secondary

    @property
    def k(self) -> int:
        """Batch-size multiplier of the update fired this iteration."""
        return len(self.update_origins)


@dataclasses.dataclass
class SchedulerConfig:
    heterogeneous: bool = True     # second (slow) link available
    mu: float = 1.65               # primary/secondary speed ratio
    capacity_factor: float = 1.0   # Preserver feedback scales capacities
    horizon: int = 96              # iterations to run before cycle detection
    # per-link latency + inverse-bandwidth pricing; None = the legacy
    # scalar model (unit primary, ``mu``-scaled secondary, no latency) —
    # that path is kept literally so existing plans stay byte-identical
    link_models: Optional[Dict[int, LinkModel]] = None

    def models(self) -> Dict[int, LinkModel]:
        return self.link_models or LinkModel.pair_from_mu(self.mu)


class DeftScheduler:
    """The paper's Solver: runs Algorithm 2 over profiled bucket times."""

    def __init__(self, times: BucketTimes, cfg: Optional[SchedulerConfig] = None):
        self.times = times
        self.cfg = cfg or SchedulerConfig()
        self.n = times.n

    # ---- helpers -----------------------------------------------------------
    def _caps(self, compute_time: float) -> Tuple[float, float]:
        """(primary, secondary) capacity in *nominal* comm seconds.

        With the legacy scalar model the secondary capacity is ``c / mu``
        (a duration d fits iff ``d * mu <= c``).  With per-link models the
        same conversion uses the secondary's inverse bandwidth; the
        latency term cannot be folded into a capacity and is charged
        per-item by the selection helpers instead."""
        c = compute_time * self.cfg.capacity_factor
        if not self.cfg.heterogeneous:
            return c, 0.0
        if self.cfg.link_models is None:
            return c, c / self.cfg.mu
        models = self.cfg.models()
        lm0 = models.get(0, LinkModel())
        lm1 = models.get(1, LinkModel(0.0, self.cfg.mu))
        return c / max(lm0.inv_bw, 1e-12), c / max(lm1.inv_bw, 1e-12)

    def _sec_fill(
        self, ordered: List[Task], cap_s: float
    ) -> Tuple[List[Task], List[Task]]:
        """Longest-first greedy fill of the slow link; returns
        (secondary, remaining).  ``cap_s`` is in nominal seconds; with
        per-link models each placed item is additionally charged the
        secondary latency (converted to nominal units)."""
        times = [self.times.comm[t.bucket] for t in ordered]
        lat = 0.0
        if self.cfg.link_models is not None:
            lm1 = self.cfg.models().get(1, LinkModel())
            lat = lm1.latency / max(lm1.inv_bw, 1e-12)
        sec: List[Task] = []
        for i in sorted(range(len(ordered)), key=lambda j: -times[j]):
            if times[i] + lat <= cap_s:
                sec.append(ordered[i])
                cap_s -= times[i] + lat
        return sec, [t for t in ordered if t not in sec]

    def _select_two_link(
        self, tasks: List[Task], cap_p: float, cap_s: float
    ) -> Tuple[List[Task], List[Task], List[Task]]:
        """(primary, secondary, leftover) from a task list via Problem 2."""
        times = [self.times.comm[t.bucket] for t in tasks]
        if self.cfg.link_models is not None:
            # charge per-item link latencies (nominal units) by shrinking
            # the offered durations' headroom: items are priced at
            # duration + latency/inv_bw on each link
            models = self.cfg.models()
            lm0 = models.get(0, LinkModel())
            lm1 = models.get(1, LinkModel())
            lat_p = lm0.latency / max(lm0.inv_bw, 1e-12)
            lat_s = lm1.latency / max(lm1.inv_bw, 1e-12)
            if lat_p > 0.0 or lat_s > 0.0:
                # distinct per-link weights: greedy secondary fill first
                # (longest-first, true secondary cost), exact DP on the
                # primary over the rest at true primary cost
                sec, rest = self._sec_fill(tasks, cap_s)
                rest_w = [self.times.comm[t.bucket] + lat_p for t in rest]
                sel = naive_knapsack(rest_w, cap_p)
                prim = [rest[i] for i in sel]
                leftover = [t for t in rest if t not in prim]
                return prim, sec, leftover
        p_idx, s_idx = knapsack_two_link(times, cap_p, cap_s)
        chosen = set(p_idx) | set(s_idx)
        return (
            [tasks[i] for i in p_idx],
            [tasks[i] for i in s_idx],
            [tasks[i] for i in range(len(tasks)) if i not in chosen],
        )

    def _select_backward_recursive(
        self, tasks: List[Task], cap_p: float, cap_s: float
    ) -> Tuple[List[Task], List[Task], List[Task]]:
        """Algorithm 1 for the backward stage over a *fresh* generation.

        Fresh gradients become ready output-side-first, and bucket 0 (input
        layer) is excluded — its comm is the hard dependency DeFT delays.
        The secondary link is filled greedily first; the primary uses the
        dependency-aware recursion.
        """
        # order tasks in backward production order: bucket n-1 ... 1
        ordered = sorted(
            [t for t in tasks if t.bucket != 0], key=lambda t: -t.bucket
        )
        frozen = [t for t in tasks if t.bucket == 0]
        sec: List[Task] = []
        if cap_s > 0 and ordered:
            sec, ordered = self._sec_fill(ordered, cap_s)
        comm = [self.times.comm[t.bucket] for t in ordered]
        bwd = [self.times.bwd[t.bucket] for t in ordered]
        sel = recursive_knapsack(comm, cap_p, bwd)
        prim = [ordered[i] for i in sel]
        leftover = [t for t in ordered if t not in prim] + frozen
        return prim, sec, leftover

    @staticmethod
    def _merge(future: List[Task], fresh: List[Task]) -> List[Task]:
        """Bucket-wise merge of the future queue into a fresh generation
        (gradient accumulation — tensor size unchanged)."""
        by_bucket: Dict[int, Tuple[int, ...]] = {t.bucket: t.origins for t in future}
        out = []
        for t in fresh:
            extra = by_bucket.get(t.bucket, ())
            out.append(Task(t.bucket, tuple(sorted(extra + t.origins))))
        return out

    # ---- the state machine ---------------------------------------------------
    def run(self, n_iterations: Optional[int] = None) -> List[IterationPlan]:
        n_iterations = n_iterations or self.cfg.horizon
        t_ = self.times
        current_q: List[Task] = []
        future_q: List[Task] = []
        plans: List[IterationPlan] = []

        for it in range(n_iterations):
            case_label = []
            fwd_p: List[Task] = []
            fwd_s: List[Task] = []
            # ---------------- forward stage (Case 1) ----------------
            if current_q:
                case_label.append("case1")
                cap_p, cap_s = self._caps(t_.fwd_total)
                fwd_p, fwd_s, current_q = self._select_two_link(
                    current_q, cap_p, cap_s
                )
            # ---------------- backward stage ----------------
            fresh = [Task(b, (it,)) for b in range(self.n)]
            bwd_p: List[Task] = []
            bwd_s: List[Task] = []
            new_to_future = False
            update = False
            update_origins: Tuple[int, ...] = ()

            cap_p, cap_s = self._caps(t_.bwd_total)
            if not current_q:
                # -------- Case 4 --------
                case_label.append("case4")
                if future_q:
                    fresh = self._merge(future_q, fresh)
                    future_q = []
                # exclude the first-computed bucket's backward from capacity:
                # nothing is ready to communicate while it runs
                cap_p = max(cap_p - t_.bwd[self.n - 1] * self.cfg.capacity_factor, 0.0)
                bwd_p, bwd_s, leftover = self._select_backward_recursive(
                    fresh, cap_p, cap_s
                )
                current_q = leftover
                if not leftover:
                    # whole generation synced within its own iteration
                    update = True
                    update_origins = tuple(
                        sorted({o for t in fresh for o in t.origins})
                    )
            else:
                covered = naive_knapsack(
                    [t_.comm[t.bucket] for t in current_q], cap_p + cap_s
                )
                if len(covered) < len(current_q):
                    # -------- Case 2 --------
                    case_label.append("case2")
                    bwd_p, bwd_s, current_q = self._select_two_link(
                        current_q, cap_p, cap_s
                    )
                    future_q = self._merge(future_q, fresh) if future_q else fresh
                    new_to_future = True
                else:
                    # -------- Case 3 --------
                    case_label.append("case3")
                    old = list(current_q)
                    # schedule the whole current queue first (greedy split
                    # across the two links, secondary takes what fits)
                    bwd_p, bwd_s, residue = self._select_two_link(
                        old, cap_p, cap_s
                    )
                    if residue:
                        # bin-packing split failure despite total-capacity
                        # cover — degrade to Case 2 semantics for residue
                        case_label[-1] = "case2"
                        current_q = residue
                        future_q = self._merge(future_q, fresh) if future_q else fresh
                        new_to_future = True
                    else:
                        used_p = sum(t_.comm[t.bucket] for t in bwd_p)
                        used_s = sum(t_.comm[t.bucket] for t in bwd_s)
                        if future_q:
                            fresh = self._merge(future_q, fresh)
                            future_q = []
                        p2, s2, leftover = self._select_backward_recursive(
                            fresh, max(cap_p - used_p, 0.0), max(cap_s - used_s, 0.0)
                        )
                        bwd_p += p2
                        bwd_s += s2
                        current_q = leftover
                        update = True
                        update_origins = tuple(
                            sorted({o for t in old for o in t.origins})
                        )

            # ---- liveness fallback ----
            # §III.D guarantees every bucket fits the smallest knapsack via
            # re-partitioning; if a caller feeds un-partitioned buckets
            # larger than any capacity, the knapsacks select nothing and
            # the queues would starve.  Force the smallest pending bucket
            # through the primary link so the system always progresses
            # (the Preserver feedback then grows capacity as usual).
            if not (fwd_p or fwd_s or bwd_p or bwd_s) and current_q:
                forced = min(current_q, key=lambda t_k: t_.comm[t_k.bucket])
                current_q = [t for t in current_q if t is not forced]
                bwd_p.append(forced)
                case_label.append("forced")
                if not current_q:
                    update = True
                    update_origins = tuple(
                        sorted({o for o in forced.origins})
                    )

            # completed-in-forward generation: if the forward stage emptied
            # the queue and backward was Case 4, the emptied generation's
            # update fires now.
            if "case4" in case_label and (fwd_p or fwd_s) and not update:
                update = True
                update_origins = tuple(
                    sorted({o for t in (fwd_p + fwd_s) for o in t.origins})
                )

            plans.append(
                IterationPlan(
                    iteration=it,
                    case="+".join(case_label) or "case4",
                    fwd_primary=tuple(fwd_p),
                    fwd_secondary=tuple(fwd_s),
                    bwd_primary=tuple(bwd_p),
                    bwd_secondary=tuple(bwd_s),
                    new_to_future=new_to_future,
                    update=update,
                    update_origins=update_origins,
                )
            )
        return plans


# ---------------------------------------------------------------------------
# Periodic schedule extraction
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PhaseSpec:
    """One step of the periodic schedule in *train-step* terms (static —
    becomes a distinct compiled executable).

    route_new:   per-bucket routing of the freshly computed gradient:
                 'sync'    — all-reduce it this step (possibly merged with
                             the future accumulator),
                 'future'  — add into the future accumulator,
                 'current' — it becomes part of the new current generation
                             (leftover of Case 3/4), stored in cur_accum.
    sync_cur:    per-bucket mask — all-reduce the *current* accumulator.
    secondary:   per-bucket mask — the sync (new or cur) rides the slow
                 link (pod/DCN hierarchical all-reduce on multi-pod).
    rotate:      future accumulator becomes the current one after this step.
    do_update:   apply the optimizer with the completed generation.
    update_k:    number of merged origins in the applied gradient.
    """

    route_new: Tuple[str, ...]
    sync_cur: Tuple[bool, ...]
    secondary: Tuple[bool, ...]
    rotate: bool
    do_update: bool
    update_k: int
    # which accumulator feeds the update: 'cur' (an older generation
    # completed this step) or 'new' (Case 4: the fresh generation synced
    # fully within its own iteration).
    update_source: str = "cur"


@dataclasses.dataclass(frozen=True)
class DeftSchedule:
    """Periodic schedule: ``phases[i % period]`` drives step i."""

    plans: Tuple[IterationPlan, ...]       # one period worth of plans
    phases: Tuple[PhaseSpec, ...]
    period: int
    updates_per_period: int
    batch_size_sequence: Tuple[int, ...]   # k_i multipliers (Preserver input)

    @property
    def update_frequency(self) -> float:
        return self.updates_per_period / max(self.period, 1)

    @property
    def comm_volume_fraction(self) -> float:
        """Synced bucket-instances per period / (period * n_buckets)."""
        n = len(self.phases[0].route_new)
        synced = sum(len(p.synced) for p in self.plans)
        return synced / max(self.period * n, 1)


def _state_signature(plan: IterationPlan) -> Tuple:
    """Structure of an iteration used for cycle detection: bucket ids and
    *relative* origin offsets (absolute iteration numbers shift each cycle)."""

    def rel(tasks: Tuple[Task, ...]):
        return tuple(
            (t.bucket, tuple(plan.iteration - o for o in t.origins)) for t in tasks
        )

    return (
        plan.case,
        rel(plan.fwd_primary),
        rel(plan.fwd_secondary),
        rel(plan.bwd_primary),
        rel(plan.bwd_secondary),
        plan.new_to_future,
        plan.update,
        len(plan.update_origins),
    )


def _plan_to_phase(plan: IterationPlan, n_buckets: int) -> PhaseSpec:
    route = ["current"] * n_buckets   # default: leftover of a generation
    sync_cur = [False] * n_buckets
    secondary = [False] * n_buckets
    fresh_synced = {t.bucket for t in plan.synced if plan.iteration in t.origins}
    old_synced = {t.bucket for t in plan.synced if plan.iteration not in t.origins}
    sec_buckets = {
        t.bucket for t in (plan.fwd_secondary + plan.bwd_secondary)
    }
    for b in range(n_buckets):
        if b in fresh_synced:
            route[b] = "sync"
        elif plan.new_to_future:
            route[b] = "future"
        if b in old_synced:
            sync_cur[b] = True
        if b in sec_buckets:
            secondary[b] = True
    # the fresh generation rotates into `cur` whenever Case 3/4 ran this
    # iteration — also when the liveness fallback appended "+forced" (a
    # forced fresh-origin sync still belongs to the rotated generation;
    # matching on endswith() here used to leave rotate=False and strand
    # an update_source="new" phase with no generation to update from)
    labels = plan.case.split("+")
    rotate = "case3" in labels or "case4" in labels
    update_source = (
        "new" if plan.update and plan.iteration in plan.update_origins else "cur"
    )
    return PhaseSpec(
        route_new=tuple(route),
        sync_cur=tuple(sync_cur),
        secondary=tuple(secondary),
        rotate=rotate,
        do_update=plan.update,
        update_k=max(len(plan.update_origins), 1),
        update_source=update_source,
    )


def extract_schedule(
    plans: Sequence[IterationPlan], n_buckets: int, warmup: int = 16
) -> DeftSchedule:
    """Detect the steady-state cycle and package it as a DeftSchedule."""
    sigs = [_state_signature(p) for p in plans]
    body = sigs[warmup:]
    period = len(body)
    for p in range(1, len(body) // 2 + 1):
        if all(body[i] == body[i % p] for i in range(len(body))):
            period = p
            break
    cycle = tuple(plans[warmup : warmup + period])
    phases = tuple(_plan_to_phase(pl, n_buckets) for pl in cycle)
    updates = sum(1 for pl in cycle if pl.update)
    ks = tuple(pl.k for pl in cycle if pl.update)
    return DeftSchedule(
        plans=cycle,
        phases=phases,
        period=period,
        updates_per_period=updates,
        batch_size_sequence=ks,
    )
