"""Two-stream discrete-event timeline simulator.

The paper evaluates wall-clock throughput on a real 16-GPU cluster.  This
container has no cluster, so the *timeline* consequences of each scheduling
scheme (iteration time, bubbles, speedups — Figs. 10-16) are reproduced
with an event-driven model faithful to WFBP semantics:

* one serial **compute stream** (backward ``n-1..0`` then next iteration's
  forward ``0..n-1``),
* one or two FIFO **communication links** (primary; optional secondary at
  ``1/mu`` speed),
* dependency edges: a fresh bucket's comm starts only after its backward;
  a baseline's next-iteration forward of bucket ``b`` waits for bucket
  ``b``'s sync (the hard dependency DeFT removes); DeFT's forward-stage
  comms are WaitAll'ed at forward end (Algorithm 2 line 12).

The simulator runs either a :class:`BaselinePolicy` or a DeFT plan list and
reports steady-state iteration time + bubble fraction.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.bucket import BucketTimes
from repro_torch.core.links import LinkModel
from repro_torch.core.policies import BaselinePolicy
from repro_torch.core.scheduler import IterationPlan, Task


@dataclasses.dataclass
class SimResult:
    name: str
    iteration_time: float          # steady-state seconds/iteration
    compute_time: float            # pure compute per iteration
    bubble_fraction: float         # (iter - compute) / iter
    updates_per_iteration: float   # 1.0 for baselines; <=1 for DeFT
    timeline: Optional[List[Tuple[str, float, float, str]]] = None
    # timeline entries: (stream, start, end, label)
    # per-iteration wall durations (incl. warmup iterations) — the adapt
    # control plane consumes these as synthetic per-phase telemetry
    iteration_durations: Tuple[float, ...] = ()
    # decoupled AG streaming (DESIGN.md §12): steady-state seconds per
    # iteration the forward stalled waiting for a late all-gather
    ag_stall_s: float = 0.0

    @property
    def throughput_speedup_vs(self):
        return lambda other: other.iteration_time / self.iteration_time


class _Link:
    def __init__(self, model: LinkModel = LinkModel()):
        self.free_at = 0.0
        self.model = model

    def transmit(self, ready: float, duration: float) -> Tuple[float, float]:
        start = max(self.free_at, ready)
        end = start + self.model.time(duration)
        self.free_at = end
        return start, end


def simulate_baseline(
    times: BucketTimes,
    policy: BaselinePolicy,
    n_iterations: int = 12,
    keep_timeline: bool = False,
) -> SimResult:
    n = times.n
    link = _Link()
    t = 0.0
    timeline: List[Tuple[str, float, float, str]] = []
    comm_done: Dict[int, float] = {}   # bucket -> completion of last sync
    iter_starts: List[float] = []

    for it in range(n_iterations):
        iter_starts.append(t)
        # ---- forward (of this iteration; consumes last iteration's syncs)
        for b in range(n):
            if it > 0:
                if policy.overlap_forward:
                    t = max(t, comm_done.get(b, 0.0))
                # non-overlapping DDP handled after backward below
            s = t
            t += times.fwd[b]
            if keep_timeline:
                timeline.append(("compute", s, t, f"F{b}@{it}"))
        # ---- backward: produce gradients n-1..0
        ready: Dict[int, float] = {}
        for b in range(n - 1, -1, -1):
            s = t
            t += times.bwd[b]
            ready[b] = t
            if keep_timeline:
                timeline.append(("compute", s, t, f"B{b}@{it}"))
        # ---- event-driven link: at each free moment serve the highest-
        # priority READY bucket (a priority queue never idles the link
        # while lower-priority gradients are waiting)
        prio = {b: i for i, b in enumerate(policy.launch_order)}
        pending = set(range(n))
        t_link = link.free_at
        while pending:
            avail = [b for b in pending if ready[b] <= t_link]
            if not avail:
                t_link = min(ready[b] for b in pending)
                continue
            b = min(avail, key=lambda x: prio[x])
            s, e = link.transmit(max(t_link, ready[b]), times.comm[b])
            t_link = e
            comm_done[b] = e
            pending.remove(b)
            if keep_timeline:
                timeline.append(("link0", s, e, f"C{b}@{it}"))
        if not policy.overlap_forward:
            # PyTorch DDP: optimizer step waits for every all-reduce
            t = max(t, max(comm_done.values()))

    compute = times.fwd_total + times.bwd_total
    span = (t - iter_starts[2]) / (n_iterations - 2)  # skip warmup iters
    return SimResult(
        name=policy.name,
        iteration_time=span,
        compute_time=compute,
        bubble_fraction=max(0.0, 1.0 - compute / span),
        updates_per_iteration=1.0,
        timeline=timeline if keep_timeline else None,
        iteration_durations=_durations(iter_starts, t),
    )


def _durations(iter_starts: List[float], t_end: float) -> Tuple[float, ...]:
    bounds = iter_starts + [t_end]
    return tuple(bounds[i + 1] - bounds[i] for i in range(len(iter_starts)))


def simulate_deft(
    times: BucketTimes,
    plans: Sequence[IterationPlan],
    mu: float = 1.65,
    heterogeneous: bool = True,
    keep_timeline: bool = False,
    name: str = "deft",
    ag_times: Optional[Sequence[float]] = None,
    ag_mode: str = "streamed",
    ag_links: Optional[Sequence[int]] = None,
    ag_skip: bool = True,
    link_models: Optional[Dict[int, LinkModel]] = None,
) -> SimResult:
    """Run the DeFT plan list through the timeline model.

    Semantics per Algorithm 2: forward-stage comms launch at forward begin
    and are WaitAll'ed at forward end; backward-stage comms of *old* tasks
    launch at backward begin, fresh tasks at their gradient-ready time;
    parameter updates happen at iteration end and wait for every synced
    task of the completed generation (stale-parameter forward means no
    other dependency exists).

    Decoupled AG extension (DESIGN.md §12): with ``ag_times`` set, an
    iteration whose params are fresh (iteration 0, or the previous plan
    updated; every iteration when ``ag_skip`` is off) transmits one
    all-gather per bucket from forward start in deadline (= model) order,
    on ``ag_links[b]`` (default: all primary).  ``ag_mode="streamed"``
    stalls forward block ``b`` until its own AG lands — late AGs cost a
    *stall*, not a WaitAll bubble; ``ag_mode="burst"`` makes the first
    block wait for every AG (the fused engine's up-front ZeRO gather
    burst, kept as the comparison baseline).

    Heterogeneous-link pricing: ``link_models`` maps link id to a
    :class:`LinkModel` (latency + inverse-bandwidth); when omitted the
    legacy scalar model applies (unit primary, ``mu``-scaled secondary,
    no latency)."""
    n = times.n
    models = dict(link_models) if link_models else LinkModel.pair_from_mu(mu)
    links = {lid: _Link(m) for lid, m in models.items()}
    links.setdefault(0, _Link(LinkModel(0.0, 1.0)))
    links.setdefault(1, _Link(LinkModel(0.0, mu)))
    t = 0.0
    timeline: List[Tuple[str, float, float, str]] = []
    iter_starts: List[float] = []
    stalls: List[float] = []
    pending_done: Dict[Tuple[int, Tuple[int, ...]], float] = {}
    n_updates = 0
    if ag_times is not None and ag_mode not in ("streamed", "burst"):
        raise ValueError(f"unknown ag_mode {ag_mode!r}")

    for idx, plan in enumerate(plans):
        it = plan.iteration
        iter_starts.append(t)
        fwd_start = t
        it_stall = 0.0
        # decoupled all-gathers: issued ahead of the fwd-stage grad comms
        # (they carry deadlines; grad comms only face a WaitAll)
        ag_done: Dict[int, float] = {}
        if ag_times is not None and (
            not ag_skip or idx == 0 or plans[idx - 1].update
        ):
            for b in range(n):
                link_id = ag_links[b] if ag_links is not None else 0
                s, e = links[link_id].transmit(fwd_start, ag_times[b])
                ag_done[b] = e
                if keep_timeline:
                    timeline.append((f"link{link_id}", s, e, f"G{b}@{it}"))
        # forward-stage comms: old tasks, resident locally, start at once
        fwd_ends: List[float] = []
        for link_id, tasks in ((0, plan.fwd_primary), (1, plan.fwd_secondary)):
            for task in tasks:
                s, e = links[link_id].transmit(fwd_start, times.comm[task.bucket])
                fwd_ends.append(e)
                pending_done[(task.bucket, task.origins)] = e
                if keep_timeline:
                    timeline.append((f"link{link_id}", s, e, f"C{task.bucket}~{task.origins}"))
        if ag_done and ag_mode == "burst":
            # the fused engine materializes every param before block 0
            burst_end = max(ag_done.values())
            it_stall += max(0.0, burst_end - t)
            t = max(t, burst_end)
        # forward compute (no per-bucket sync dependency: delayed updates;
        # streamed AGs add the one real dependency — bucket b's params)
        for b in range(n):
            if ag_mode == "streamed" and b in ag_done:
                it_stall += max(0.0, ag_done[b] - t)
                t = max(t, ag_done[b])
            s = t
            t += times.fwd[b]
            if keep_timeline:
                timeline.append(("compute", s, t, f"F{b}@{it}"))
        stalls.append(it_stall)
        # WaitAll(order) at forward end
        if fwd_ends:
            t = max(t, max(fwd_ends))
        # backward compute
        bwd_start = t
        ready: Dict[int, float] = {}
        for b in range(n - 1, -1, -1):
            s = t
            t += times.bwd[b]
            ready[b] = t
            if keep_timeline:
                timeline.append(("compute", s, t, f"B{b}@{it}"))
        # backward-stage comms
        sync_ends: List[float] = []
        for link_id, tasks in ((0, plan.bwd_primary), (1, plan.bwd_secondary)):
            for task in tasks:
                fresh = it in task.origins
                avail = ready[task.bucket] if fresh else bwd_start
                s, e = links[link_id].transmit(avail, times.comm[task.bucket])
                sync_ends.append(e)
                pending_done[(task.bucket, task.origins)] = e
                if keep_timeline:
                    timeline.append((f"link{link_id}", s, e, f"C{task.bucket}~{task.origins}"))
        # parameter update at iteration end: waits for the generation's syncs
        if plan.update:
            n_updates += 1
            gen_ends = [
                e
                for (b, origins), e in pending_done.items()
                if set(origins) & set(plan.update_origins)
            ]
            if gen_ends:
                t = max(t, max(gen_ends))

    compute = times.fwd_total + times.bwd_total
    warm = max(2, len(plans) // 4)
    span = (t - iter_starts[warm]) / max(len(plans) - warm, 1)
    updates = sum(1 for p in plans[warm:] if p.update) / max(len(plans) - warm, 1)
    return SimResult(
        name=name,
        iteration_time=span,
        compute_time=compute,
        bubble_fraction=max(0.0, 1.0 - compute / span),
        updates_per_iteration=updates,
        timeline=timeline if keep_timeline else None,
        iteration_durations=_durations(iter_starts, t),
        ag_stall_s=sum(stalls[warm:]) / max(len(plans) - warm, 1),
    )
