"""0/1 knapsack machinery (paper §III.B-C).

The scheduling problem: items are bucket *communication times* (value ==
weight), the knapsack capacity is merged *computation time*.  Three solvers:

* ``naive_knapsack``       — exact DP on microsecond-scaled integers
                             (Problem 1).
* ``recursive_knapsack``   — Algorithm 1: dependency-aware refinement for
                             the backward stage.  Scheduling the comm of the
                             deepest (output-side) bucket leaves only the
                             backward time of shallower buckets to overlap
                             with, so the recursion also tries dropping the
                             last item while shrinking capacity by that
                             bucket's backward time, and keeps the better.
* ``greedy_multi_knapsack``— Problem 2 heuristic for heterogeneous links:
                             capacities sorted ascending, items placed
                             longest-first into the smallest knapsack with
                             room.
* ``deadline_knapsack``    — decoupled-collective extension (DESIGN.md
                             §12): all-gather items streamed against the
                             forward pass carry a *deadline* (the start of
                             the first forward block that consumes the
                             bucket); selection maximizes covered time
                             over EDF-feasible subsets.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np

_SCALE = 1e6  # seconds -> integer microseconds for exact DP
# Bound the DP table: with n items the capacity axis is clamped to
# _MAX_DP_CELLS / n cells (the rescale loop below coarsens the integer
# unit).  1M cells keeps every solve a few ms with <=0.1% capacity error
# at the paper's scales (ms..s bucket times).
_MAX_DP_CELLS = 1_000_000

# The Solver re-solves near-identical knapsack instances every iteration
# of its 96-step horizon (same bucket times, a handful of distinct
# capacities), and the Planner's Preserver feedback loop repeats the whole
# horizon up to 10 times.  Memoizing the integer-domain DP short-circuits
# all of that; results are EXACT cache hits (keys are the already-scaled
# integer weights + capacity, so there is no float-tolerance issue).
_MEMO_ENABLED = True
_MEMO_SIZE = 1 << 14


def set_knapsack_memoization(enabled: bool) -> bool:
    """Toggle the DP memo caches (benchmarks/tests); returns prior state."""
    global _MEMO_ENABLED
    prev = _MEMO_ENABLED
    _MEMO_ENABLED = bool(enabled)
    return prev


def clear_knapsack_caches() -> None:
    _naive_knapsack_int.cache_clear()
    _deadline_knapsack_int.cache_clear()


def knapsack_cache_info():
    """functools cache stats of the memoized DP core."""
    return _naive_knapsack_int.cache_info()


def deadline_knapsack_cache_info():
    """functools cache stats of the memoized deadline-DP core."""
    return _deadline_knapsack_int.cache_info()


def _to_int(xs: Sequence[float]) -> List[int]:
    return [max(0, int(round(x * _SCALE))) for x in xs]


@functools.lru_cache(maxsize=_MEMO_SIZE)
def _naive_knapsack_int(w: Tuple[int, ...], cap: int) -> Tuple[int, ...]:
    """Exact 0/1 DP over integer weights (value == weight); memoized.

    vectorized classic 0/1 DP: `cand` reads the pre-update row, so each
    item is used at most once; `choice` records per-item improvements
    for the backtrack."""
    n = len(w)
    dp = np.zeros(cap + 1, np.int64)
    choice = np.zeros((n, cap + 1), bool)
    for i in range(n):
        wi = w[i]
        if wi == 0:
            choice[i, :] = True   # zero-weight item always fits
            continue
        if wi > cap:
            continue
        cand = dp[: cap + 1 - wi] + wi
        better = cand > dp[wi:]
        dp[wi:] = np.where(better, cand, dp[wi:])
        choice[i, wi:] = better
    # backtrack
    sel: List[int] = []
    c = cap
    for i in range(n - 1, -1, -1):
        if choice[i, c]:
            sel.append(i)
            c -= w[i]
            if c < 0:
                c = 0
    sel.reverse()
    return tuple(sel)


def naive_knapsack(times: Sequence[float], capacity: float) -> List[int]:
    """Exact 0/1 knapsack (value == weight). Returns selected item indices.

    The DP runs on microsecond-scaled integers and is memoized across
    calls (the scheduler solves near-identical instances every horizon
    iteration — see ``set_knapsack_memoization``)."""
    n = len(times)
    if n == 0 or capacity <= 0:
        return []
    w = _to_int(times)
    # round (not truncate) so an exactly-fitting item is not rejected by
    # float noise; weights above use the same rounding
    cap = int(round(capacity * _SCALE))
    if cap <= 0:
        return []
    # Rescale to keep the DP table bounded (profiled capacities are
    # hundreds of ms = ~1e6 integer cells; the table stays a few MB).
    # Nonzero items stay >= 1 after rescaling — a coarsened-to-zero item
    # is NOT free and must still compete for capacity.
    while n * cap > _MAX_DP_CELLS and cap > 1:
        w = [max(x // 10, 1) if x > 0 else 0 for x in w]
        cap //= 10
    if _MEMO_ENABLED:
        sel = list(_naive_knapsack_int(tuple(w), cap))
    else:
        sel = list(_naive_knapsack_int.__wrapped__(tuple(w), cap))
    # rounding error is bounded by one (possibly rescaled) integer unit
    # per item; keep the matching tolerance
    unit = max(round(capacity * _SCALE), 1) / max(cap, 1) / _SCALE
    assert sum(times[i] for i in sel) <= capacity * 1.001 + n * unit + 1e-6
    return sel


@functools.lru_cache(maxsize=_MEMO_SIZE)
def _deadline_knapsack_int(
    w: Tuple[int, ...], d: Tuple[int, ...], cap: int
) -> Tuple[int, ...]:
    """Deadline-constrained reachability DP over positive integer weights.

    Items arrive pre-sorted by deadline (EDF order — any feasible subset
    stays feasible when transmitted in deadline order, so restricting the
    DP to that order loses nothing).  State: the set of reachable
    cumulative link times; adding item i at cumulative time c requires
    ``c + w[i] <= min(d[i], cap)``.  The memo key includes the deadline
    tuple — two instances identical except for deadlines are *different*
    problems and must not alias in the cache.
    """
    n = len(w)
    reach = np.zeros(cap + 1, bool)
    reach[0] = True
    choice = np.zeros((n, cap + 1), bool)
    for i in range(n):
        wi = w[i]
        di = min(d[i], cap)
        if wi <= 0 or wi > di:
            continue
        cand = np.zeros(cap + 1, bool)
        cand[wi : di + 1] = reach[: di + 1 - wi]
        new = cand & ~reach
        choice[i] = new          # first setter of each cumulative time
        reach |= new
    best = int(np.flatnonzero(reach)[-1])
    sel: List[int] = []
    c = best
    for i in range(n - 1, -1, -1):
        if choice[i, c]:
            sel.append(i)
            c -= w[i]
    sel.reverse()
    return tuple(sel)


def deadline_knapsack(
    times: Sequence[float],
    deadlines: Sequence[float],
    capacity: float,
) -> List[int]:
    """Deadline-constrained 0/1 knapsack (value == weight).

    Items are link transfers issued back-to-back from time zero in
    deadline (EDF) order; a selected item must *finish* by its deadline
    or it stalls the consumer instead of hiding behind it.  Returns the
    selected original indices maximizing total covered time subject to
    the per-item deadlines and the overall ``capacity``.

    Used for the decoupled all-gather items (DESIGN.md §12): deadline =
    the forward-prefix time at which the first block consuming the
    bucket starts, capacity = the forward compute window.
    """
    n = len(times)
    if n == 0 or capacity <= 0:
        return []
    if len(deadlines) != n:
        raise ValueError(
            f"deadline_knapsack: {n} times but {len(deadlines)} deadlines"
        )
    order = sorted(range(n), key=lambda i: (deadlines[i], i))
    w = _to_int([times[i] for i in order])
    d = _to_int([min(deadlines[i], capacity) for i in order])
    cap = int(round(capacity * _SCALE))
    if cap <= 0:
        return []
    while n * cap > _MAX_DP_CELLS and cap > 1:
        w = [max(x // 10, 1) if x > 0 else 0 for x in w]
        d = [x // 10 for x in d]
        cap //= 10
    # zero-duration items consume no link time and can be issued at time
    # zero ahead of everything: always covered, kept out of the DP
    sel = [order[j] for j in range(n) if w[j] == 0]
    pos = [j for j in range(n) if w[j] > 0]
    if pos:
        wp = tuple(w[j] for j in pos)
        dp_key = tuple(d[j] for j in pos)
        if _MEMO_ENABLED:
            picked = _deadline_knapsack_int(wp, dp_key, cap)
        else:
            picked = _deadline_knapsack_int.__wrapped__(wp, dp_key, cap)
        sel += [order[pos[k]] for k in picked]
    sel.sort()
    # EDF feasibility of the float-domain selection, up to one (possibly
    # rescaled) integer unit per item of rounding slack
    unit = max(round(capacity * _SCALE), 1) / max(cap, 1) / _SCALE
    t = 0.0
    for i in sorted(sel, key=lambda j: (deadlines[j], j)):
        t += times[i]
        assert t <= min(deadlines[i], capacity) * 1.001 + n * unit + 1e-6, (
            "deadline_knapsack produced an EDF-infeasible selection"
        )
    return sel


def recursive_knapsack(
    comm_times: Sequence[float],
    remain_time: float,
    bwd_times: Sequence[float],
    _depth: int = 0,
) -> List[int]:
    """Algorithm 1 (RecursiveKnapsack).

    ``comm_times``/``bwd_times`` are ordered as produced by backward:
    position 0 is bucket N (output side, gradient ready first), the last
    position is the shallowest considered bucket.  ``order1`` solves the
    plain knapsack; ``order2`` drops the *last* element (the shallowest
    bucket, whose comm would only start after nearly all backward is done)
    and shrinks the capacity by the backward time of its predecessor, per
    the paper's ``RecursiveKnapsack(CommTimeList - C_N, remainTime -
    T_{N-1})`` step.  The better total wins.
    """
    n = len(comm_times)
    if n == 0 or remain_time <= 0:
        return []
    if sum(comm_times) <= remain_time:
        return list(range(n))   # everything fits; recursion cannot improve
    order1 = naive_knapsack(comm_times, remain_time)
    if n == 1 or _depth > 30:
        return order1
    shrink = bwd_times[n - 2] if n - 2 < len(bwd_times) else 0.0
    s1 = sum(comm_times[i] for i in order1)
    # Fast path: the recursive branch solves with capacity shrunk by the
    # predecessor's backward time, so its total can never exceed
    # remain_time - shrink.  If the plain solve already saturates that,
    # recursing cannot win — skip the whole subtree.
    if s1 >= remain_time - shrink:
        return order1
    order2 = recursive_knapsack(
        comm_times[: n - 1], remain_time - shrink, bwd_times, _depth + 1
    )
    s2 = sum(comm_times[i] for i in order2)
    return order1 if s1 >= s2 else order2


def greedy_multi_knapsack(
    times: Sequence[float], capacities: Sequence[float]
) -> Dict[int, List[int]]:
    """Problem 2 greedy heuristic (§III.C): returns {knapsack_id: item
    indices}, knapsack ids indexing ``capacities`` as given.  Placement:
    capacities ascending, items by time descending, each item into the
    smallest-capacity knapsack that still has room.  O(N*M)."""
    order_caps = sorted(range(len(capacities)), key=lambda k: capacities[k])
    remaining = {k: capacities[k] for k in order_caps}
    items = sorted(range(len(times)), key=lambda i: -times[i])
    placed: Dict[int, List[int]] = {k: [] for k in range(len(capacities))}
    for i in items:
        for k in order_caps:
            if times[i] <= remaining[k]:
                placed[k].append(i)
                remaining[k] -= times[i]
                break
    for k in placed:
        placed[k].sort()
    return placed


def knapsack_two_link(
    times: Sequence[float],
    primary_capacity: float,
    secondary_capacity: float,
) -> Tuple[List[int], List[int]]:
    """Two-knapsack selection (primary=ICI/NCCL, secondary=slow link).

    Returns (primary_items, secondary_items).  Uses the greedy heuristic,
    then locally improves the primary set with the exact DP over the items
    the greedy left out or placed on the primary link, re-offering any
    item the refinement evicted (or the greedy never placed) to the
    residual secondary capacity.  The refined split is adopted only when
    its *total* covered time beats the greedy's — comparing primary load
    alone could adopt a split that evicts greedy picks outright and
    covers less overall."""
    placed = greedy_multi_knapsack(times, [primary_capacity, secondary_capacity])
    primary, secondary = placed.get(0, []), placed.get(1, [])
    # refinement: re-solve the primary knapsack exactly over all items not
    # on the secondary link
    free = [i for i in range(len(times)) if i not in secondary]
    sub = naive_knapsack([times[i] for i in free], primary_capacity)
    primary2 = [free[j] for j in sub]
    # evicted greedy picks and never-placed items compete for what the
    # secondary link has left, longest-first (the greedy's own ordering)
    secondary2 = list(secondary)
    residual = secondary_capacity - sum(times[i] for i in secondary)
    for i in sorted(set(free) - set(primary2), key=lambda j: -times[j]):
        if times[i] <= residual:
            secondary2.append(i)
            residual -= times[i]
    covered = lambda prim, sec: (
        sum(times[i] for i in prim) + sum(times[i] for i in sec)
    )
    if covered(primary2, secondary2) > covered(primary, secondary):
        primary, secondary = primary2, secondary2
    return sorted(primary), sorted(secondary)
