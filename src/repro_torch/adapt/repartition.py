"""Online repartitioning: candidate bucket partitions for the replanner.

DeFT's third lever is fixing "imbalanced communication/computation times
of tensors caused by partitioning/fusion strategies": when calibration
reveals the effective compute/comm ratio moved (a bandwidth drop, an MFU
mis-estimate), the best *partition* — not just the best schedule over the
installed partition — may change, the exact failure mode MG-WFBP shows
for naive merge choices.  This module generates the candidate partitions
the controller feeds to :meth:`repro_torch.core.deft.Planner.plan` as a
candidate grid.

Everything here is pure Python off the hot path: a
:class:`~repro_torch.train.bucketing.LeafTimeModel` (frozen per-leaf timing
atoms, built once from the parameter tree's shapes) re-aggregates bucket
times for any candidate partition, scaled by the cumulative calibrated
(comp, comm) drift.  Candidates come from two generators:

* the legacy ``partition_elems`` factor grid (greedy model-order fill at
  a handful of bucket-size targets), and
* :func:`dp_partition` — an exact per-boundary DP over the leaf order
  that minimizes :func:`exposed_makespan`, the serialized-link
  backward-overlap surrogate (MG-WFBP's objective).  The greedy fill
  only controls bucket *size*; the DP places each boundary where the
  compute/comm overlap actually wants it, which is the partition lever
  the paper's third failure mode is about.

The runtime side — re-packing the flat state into the chosen partition's
:class:`BucketLayout` at a cycle boundary — lives in
``DeftRuntime.prepare_swap(..., layout=...)`` (DESIGN.md §9).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.bucket import BucketTimes
from repro_torch.train.bucketing import LeafTimeModel


def exposed_makespan(
    model: LeafTimeModel,
    bucket_of_leaf: Sequence[int],
    n_buckets: int,
    *,
    comp_scale: float = 1.0,
    comm_scale: float = 1.0,
) -> float:
    """Serialized-link backward-overlap makespan of a partition.

    The surrogate the boundary DP optimizes: backward visits buckets in
    reverse model order; each bucket's grad-sync becomes launchable when
    its backward finishes and the (single, serialized) link transmits
    launchable buckets FIFO.  The returned value is when the last sync
    lands — total backward plus whatever communication stayed exposed.
    Latency-bearing ``allreduce_time`` pricing means over-splitting
    penalizes itself.  Cheap (O(n_leaves)), exact for the surrogate, and
    deliberately simulator-free: the real simulator ranks the surviving
    candidates downstream in the Planner.
    """
    bwd = [0.0] * n_buckets
    elems = [0] * n_buckets
    for i, b in enumerate(bucket_of_leaf):
        bwd[b] += 2.0 * model.fwd_s[i]
        elems[b] += model.elems[i]
    c_scale = model.comm_scale * comm_scale
    t = 0.0        # backward clock
    free = 0.0     # link free time
    for b in reversed(range(n_buckets)):
        t += bwd[b] * comp_scale
        free = max(free, t) + model.hw.allreduce_time(elems[b]) * c_scale
    return free


def dp_partition(
    model: LeafTimeModel,
    *,
    comp_scale: float = 1.0,
    comm_scale: float = 1.0,
    max_buckets: Optional[int] = None,
) -> Tuple[Tuple[int, ...], int]:
    """Exact boundary placement: the contiguous (model-order) partition
    minimizing :func:`exposed_makespan`, by DP over leaf boundaries.

    Works in backward processing order (reverse model order), where the
    makespan obeys ``finish(s..e) = max(finish(prefix), bwd_prefix[e]) +
    comm(s..e)`` — monotone in ``finish(prefix)``, so minimizing the
    finish time at every boundary is optimal substructure and an
    O(n_leaves^2) sweep is exact over ALL boundary placements (the
    greedy fill can only ever produce one of them, hence DP <= greedy
    under the surrogate — the property tests pin this).  ``max_buckets``
    optionally bounds the bucket count (adds a segment-count DP
    dimension).  Returns ``(bucket_of_leaf, n_buckets)`` in
    :func:`~repro_torch.train.bucketing.greedy_fill_partition` shape.
    """
    order = model.order
    L = len(order)
    if L == 0:
        return (), 0
    # per-position atoms in backward processing order
    proc = tuple(reversed(order))
    bwd_pfx = [0.0] * (L + 1)
    el_pfx = [0] * (L + 1)
    for p, leaf in enumerate(proc):
        bwd_pfx[p + 1] = bwd_pfx[p] + 2.0 * model.fwd_s[leaf] * comp_scale
        el_pfx[p + 1] = el_pfx[p] + model.elems[leaf]
    c_scale = model.comm_scale * comm_scale

    def comm(s: int, e: int) -> float:
        return model.hw.allreduce_time(el_pfx[e] - el_pfx[s]) * c_scale

    INF = float("inf")
    if max_buckets is None:
        # unbounded: the finish time is monotone in the prefix's finish
        # time, so one O(L^2) sweep suffices — no segment-count state
        dp = [INF] * (L + 1)
        back = [0] * (L + 1)
        dp[0] = 0.0
        for e in range(1, L + 1):
            for s in range(e):
                f = max(dp[s], bwd_pfx[e]) + comm(s, e)
                if f < dp[e]:
                    dp[e], back[e] = f, s
        bounds = [L]
        while bounds[-1] > 0:
            bounds.append(back[bounds[-1]])
        bounds.reverse()                  # 0 = bounds[0] < ... < L
        k_best = len(bounds) - 1
    else:
        # bounded: layered DP, dp[k][e] = best finish covering proc[:e]
        # with exactly k segments — O(L^2 * max_buckets)
        kmax = min(max_buckets, L)
        dpk = [[INF] * (L + 1) for _ in range(kmax + 1)]
        backk: dict = {}
        dpk[0][0] = 0.0
        for k in range(1, kmax + 1):
            for e in range(1, L + 1):
                best, arg = INF, -1
                for s in range(k - 1, e):
                    prev = dpk[k - 1][s]
                    if prev == INF:
                        continue
                    f = max(prev, bwd_pfx[e]) + comm(s, e)
                    if f < best:
                        best, arg = f, s
                dpk[k][e] = best
                if arg >= 0:
                    backk[(k, e)] = arg
        k_best = min(range(1, kmax + 1), key=lambda k: dpk[k][L])
        bounds = [L]
        k, e = k_best, L
        while k > 0:
            e = backk[(k, e)]
            bounds.append(e)
            k -= 1
        bounds.reverse()                  # 0 = bounds[0] < ... < L
    # proc segment j (earliest backward) is model-order bucket
    # k_best - 1 - j; emit flat-leaf-indexed assignment
    bucket_of = [0] * L
    for j in range(k_best):
        for p in range(bounds[j], bounds[j + 1]):
            bucket_of[proc[p]] = k_best - 1 - j
    return tuple(bucket_of), k_best


@dataclasses.dataclass(frozen=True)
class PartitionCandidate:
    """One candidate leaf->bucket partition, in layout-buildable terms."""

    tag: str
    partition_elems: int
    bucket_of: Tuple[int, ...]
    n_buckets: int


@dataclasses.dataclass(frozen=True)
class RepartitionConfig:
    """Knobs of the candidate generator."""

    base_partition_elems: int
    # grid of partition_elems multipliers tried around the installed one
    factors: Tuple[float, ...] = (0.5, 1.0, 2.0, 4.0)
    # relative simulated-iteration-time gain required to switch partitions
    # (a repack is cheap but not free; near-ties must not thrash)
    min_gain: float = 0.02
    # add the exact boundary-DP candidate (dp_partition) to the grid
    use_dp: bool = True
    # optional bucket-count cap for the DP (None: latency self-regulates)
    dp_max_buckets: Optional[int] = None


class Repartitioner:
    """Candidate partitions + their calibrated bucket times.

    The controller owns one of these when ``--adapt-repartition`` is on;
    every replan asks for the current candidate set, solves each through
    the Preserver-gated feedback loop, and adopts the winner.  Candidates
    are deduplicated by their ``bucket_of`` assignment (two factors that
    greedy-fill into the same partition are the same candidate), and the
    installed partition is always candidate ``"current"``.
    """

    def __init__(self, model: LeafTimeModel, cfg: RepartitionConfig):
        self.model = model
        self.cfg = cfg

    def candidates(
        self,
        current_bucket_of: Sequence[int],
        current_n_buckets: int,
        *,
        comp_scale: float = 1.0,
        comm_scale: float = 1.0,
    ) -> List[PartitionCandidate]:
        """The candidate superset: installed partition, the legacy
        greedy factor grid, and (``use_dp``) the exact boundary DP
        priced at the cumulative calibrated scales — the DP boundaries
        shift with the comp/comm ratio, which is the whole point of
        repartitioning on drift."""
        out = [PartitionCandidate(
            tag="current",
            partition_elems=self.cfg.base_partition_elems,
            bucket_of=tuple(current_bucket_of),
            n_buckets=current_n_buckets,
        )]
        seen = {out[0].bucket_of}
        for f in self.cfg.factors:
            elems = max(int(self.cfg.base_partition_elems * f), 1)
            bucket_of, nb = self.model.partition(elems)
            if bucket_of in seen:
                continue
            seen.add(bucket_of)
            out.append(PartitionCandidate(
                tag=f"elems-x{f:g}",
                partition_elems=elems,
                bucket_of=bucket_of,
                n_buckets=nb,
            ))
        if self.cfg.use_dp:
            bucket_of, nb = dp_partition(
                self.model,
                comp_scale=comp_scale, comm_scale=comm_scale,
                max_buckets=self.cfg.dp_max_buckets,
            )
            if nb and bucket_of not in seen:
                seen.add(bucket_of)
                out.append(PartitionCandidate(
                    tag="dp",
                    partition_elems=self.cfg.base_partition_elems,
                    bucket_of=bucket_of,
                    n_buckets=nb,
                ))
        return out

    def times_for(
        self,
        cand: PartitionCandidate,
        *,
        comp_scale: float = 1.0,
        comm_scale: float = 1.0,
    ) -> BucketTimes:
        """Candidate bucket times under the cumulative calibrated
        scales (what the world looks like NOW for that partition)."""
        return self.model.bucket_times(
            cand.bucket_of, cand.n_buckets,
            comp_scale=comp_scale, comm_scale=comm_scale,
        )

    def base_times_for(self, cand: PartitionCandidate) -> BucketTimes:
        """Candidate bucket times at scale 1 (the pre-drift analytic
        profile — what synthetic telemetry replays need as run-base)."""
        return self.model.bucket_times(cand.bucket_of, cand.n_buckets)


def candidate_solve_table(solves) -> str:
    """Human-readable one-line-per-candidate summary of a
    candidate-grid :meth:`~repro_torch.core.deft.Planner.plan` result
    (explorer / logs)."""
    rows = []
    for s in solves:
        rows.append(
            f"    {s.tag:<12s} n={s.times.n:2d} "
            f"iter={s.iteration_time * 1e3:8.2f}ms "
            f"period={s.schedule.period} "
            f"k-seq={s.schedule.batch_size_sequence} "
            f"preserver={'ok' if s.verdict.ok else 'REJECT'}"
        )
    return "\n".join(rows)
