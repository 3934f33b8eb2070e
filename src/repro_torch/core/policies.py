"""Baseline communication-scheduling policies (Table III).

Each policy emits, per iteration, the *launch order* of the fresh gradient
buckets' all-reduces plus whether next-iteration forward of bucket ``b``
must wait for its communication (strict WFBP parameter dependency — true
for every baseline, eliminated by DeFT's delayed updates).

Buckets are 0-based with 0 = input-most; backward produces them in order
``n-1, ..., 0``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

from repro_torch.core.bucket import BucketTimes


@dataclasses.dataclass(frozen=True)
class BaselinePolicy:
    """A launch-order policy.

    name:        scheme name.
    launch_order: bucket ids in the order the communication *queue* should
                  serve them once ready (earlier = higher priority).
    overlap_forward: whether comms may continue into next iteration's
                  forward (Bytescheduler/US-Byte yes; plain DDP no —
                  PyTorch DDP blocks the next step on all-reduce finish).
    """

    name: str
    launch_order: Sequence[int]
    overlap_forward: bool


def pytorch_ddp(times: BucketTimes) -> BaselinePolicy:
    """WFBP + tensor fusion: all-reduces launch in gradient-ready order
    (output to input) and the optimizer step (hence next forward) waits for
    all of them."""
    n = times.n
    return BaselinePolicy("pytorch-ddp", list(range(n - 1, -1, -1)), False)


def bytescheduler(times: BucketTimes) -> BaselinePolicy:
    """Priority (sequential) scheduling: smaller-index (input-side) tensors
    are prioritized so the next forward can start earliest; communications
    overlap next-iteration forward."""
    n = times.n
    return BaselinePolicy("bytescheduler", list(range(n)), True)


def usbyte(times: BucketTimes) -> BaselinePolicy:
    """US-Byte non-sequential greedy: order buckets to minimize the stall of
    next-iteration forward given unequal comm times.

    Greedy: process forward consumers in order 0..n-1; at each decision pick
    the not-yet-scheduled bucket with the *largest* comm time that still
    lets bucket b's comm finish before forward reaches layer b (estimated
    with cumulative forward prefix times); fall back to the smallest.  This
    mirrors the paper's description of a low-complexity greedy that beats
    strict priority order when tensor sizes vary."""
    n = times.n
    fwd_prefix = [0.0]
    for b in range(n):
        fwd_prefix.append(fwd_prefix[-1] + times.fwd[b])
    unscheduled = set(range(n))
    order: List[int] = []
    t_link = 0.0
    for consumer in range(n):
        if consumer not in unscheduled:
            continue
        deadline = fwd_prefix[consumer]  # fwd of layer `consumer` starts
        # candidates whose comm fits before the deadline
        fits = [b for b in unscheduled if t_link + times.comm[b] <= deadline]
        # always make sure `consumer` itself is eventually scheduled; pick
        # largest fitting, else the consumer (forced, stall accepted)
        while fits:
            pick = max(fits, key=lambda b: times.comm[b])
            order.append(pick)
            unscheduled.remove(pick)
            t_link += times.comm[pick]
            if pick == consumer:
                break
            fits = [b for b in unscheduled if t_link + times.comm[b] <= deadline]
        if consumer in unscheduled:
            order.append(consumer)
            unscheduled.remove(consumer)
            t_link += times.comm[consumer]
    order.extend(sorted(unscheduled))
    return BaselinePolicy("us-byte", order, True)


ALL_BASELINES = {
    "pytorch-ddp": pytorch_ddp,
    "bytescheduler": bytescheduler,
    "us-byte": usbyte,
}
