"""Gradient buckets and partition strategies.

Terminology follows the paper: buckets are numbered ``1..N`` from the
*input* layer to the *output* layer.  Backward propagation therefore
produces gradients in the order ``N, N-1, ..., 1``; bucket #1 is the one
whose communication carries the hard dependency (it finishes last in
backward and is needed first by the next iteration's forward).

Three partition strategies are provided, mirroring Table III:

* ``uniform``      — PyTorch-DDP style: greedy fill to a fixed bucket size.
* ``usbyte``       — US-Byte style unequal-sized re-partition that grows
                     bucket sizes geometrically from the output end so early
                     (output-side) communications are small and start early.
* ``deft``         — US-Byte partition + the paper §III.D constraint: the
                     largest bucket's communication time must stay below the
                     smallest knapsack capacity (forward time / mu);
                     over-sized buckets are split.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One gradient bucket.

    index:      1-based, 1 = input-most (paper numbering).
    n_elements: parameter count.
    layer_ids:  decoder-layer indices covered (input->output order);
                (-1,) marks the embedding bucket, (-2,) the head/final-norm.
    split:      (k, of) when the bucket is the k-th split of a partitioned
                layer group (tensor partition), else None.
    """

    index: int
    n_elements: int
    layer_ids: Tuple[int, ...]
    split: Optional[Tuple[int, int]] = None

    def wire_bytes(self, policy=None) -> int:
        """Bytes this bucket's gradient occupies on the wire under a
        :class:`~repro_torch.core.precision.PrecisionPolicy` (f32 when None).

        The policy is indexed by bucket position (``index`` is 1-based,
        matching paper numbering) — the ONE place wire bytes are derived
        from an element count; everything else prices through here or
        :func:`~repro_torch.core.precision.apply_wire_precision`."""
        if policy is None:
            return 4 * self.n_elements
        return policy.wire_bytes_per_elem(self.index - 1) * self.n_elements

    @property
    def bytes_fp32(self) -> int:
        """Deprecated shim — use :meth:`wire_bytes`.  Kept for
        out-of-tree callers; linted against in-tree by
        ``scripts/check_no_legacy_planner.py``."""
        return self.wire_bytes()


@dataclasses.dataclass(frozen=True)
class BucketTimes:
    """Profiled per-bucket times, seconds. Forward/backward are the compute
    times of the layers the bucket covers; comm is the all-reduce time of
    the bucket's gradient on the *primary* link."""

    fwd: Tuple[float, ...]
    bwd: Tuple[float, ...]
    comm: Tuple[float, ...]

    @property
    def n(self) -> int:
        return len(self.fwd)

    @property
    def fwd_total(self) -> float:
        return sum(self.fwd)

    @property
    def bwd_total(self) -> float:
        return sum(self.bwd)

    @property
    def comm_total(self) -> float:
        return sum(self.comm)

    @property
    def coverage_rate(self) -> float:
        """CR = T_comm / (T_fwd + T_bwd) — Table I."""
        return self.comm_total / max(self.fwd_total + self.bwd_total, 1e-12)


def _greedy_fill(
    layer_elems: Sequence[int], target: int
) -> List[List[int]]:
    """Group consecutive layer indices (input->output) so each group reaches
    ``target`` elements (except possibly the last)."""
    groups: List[List[int]] = []
    cur: List[int] = []
    acc = 0
    for i, n in enumerate(layer_elems):
        cur.append(i)
        acc += n
        if acc >= target:
            groups.append(cur)
            cur, acc = [], 0
    if cur:
        groups.append(cur)
    return groups


def partition_uniform(
    layer_elems: Sequence[int], bucket_elems: int
) -> List[Bucket]:
    """PyTorch-DDP-style fixed-size bucketing (default 25 MB = 6,553,600
    fp32 elements). Grouping runs input->output over layer ids; DDP actually
    fills buckets in reverse-registration (output-first) order — the bucket
    *contents* are the same consecutive layer ranges, and we keep paper
    numbering (1 = input-most)."""
    groups = _greedy_fill(layer_elems, bucket_elems)
    return [
        Bucket(index=i + 1, n_elements=sum(layer_elems[j] for j in g), layer_ids=tuple(g))
        for i, g in enumerate(groups)
    ]


def partition_usbyte(
    layer_elems: Sequence[int], base_elems: int, growth: float = 1.6
) -> List[Bucket]:
    """US-Byte-style unequal-sized partition [arXiv US-Byte, TPDS'23]:
    output-side buckets are kept small (their communications launch first
    in backward and must not delay later overlap), growing geometrically
    toward the input side.  We implement it as greedy fill with a target
    that *decays* from input to output."""
    n_layers = len(layer_elems)
    total = sum(layer_elems)
    groups: List[List[int]] = []
    cur: List[int] = []
    acc = 0
    remaining = total
    target = base_elems * growth ** 2
    for i in range(n_layers):
        cur.append(i)
        acc += layer_elems[i]
        # decay target toward the output end
        frac_done = (total - remaining) / max(total, 1)
        target_i = max(base_elems / growth, target * (1 - frac_done))
        remaining -= layer_elems[i]
        if acc >= target_i:
            groups.append(cur)
            cur, acc = [], 0
    if cur:
        groups.append(cur)
    return [
        Bucket(index=i + 1, n_elements=sum(layer_elems[j] for j in g), layer_ids=tuple(g))
        for i, g in enumerate(groups)
    ]


def partition_bytescheduler(
    layer_elems: Sequence[int], partition_elems: int
) -> List[Bucket]:
    """Bytescheduler-style tensor partition: greedy-fill groups, then SLICE
    any bucket larger than the partition size into near-equal blocks (the
    paper's 'tensor partition' — credit-sized blocks, default 6.5M)."""
    grouped = partition_uniform(layer_elems, partition_elems)
    out: List[Bucket] = []
    for b in grouped:
        if b.n_elements <= partition_elems:
            out.append(b)
            continue
        k = -(-b.n_elements // partition_elems)   # ceil
        out.extend(split_bucket(b, k, start_index=0))
    return [dataclasses.replace(b, index=i + 1) for i, b in enumerate(out)]


def split_bucket(b: Bucket, k: int, start_index: int) -> List[Bucket]:
    """Tensor-partition a bucket into k near-equal splits (paper §III.D)."""
    per = b.n_elements // k
    out = []
    for j in range(k):
        n = per if j < k - 1 else b.n_elements - per * (k - 1)
        out.append(
            Bucket(
                index=start_index + j,
                n_elements=n,
                layer_ids=b.layer_ids,
                split=(j, k),
            )
        )
    return out


def apply_deft_constraint(
    buckets: Sequence[Bucket],
    comm_time_of,           # Callable[[int elements], float]
    max_comm_time: float,
) -> List[Bucket]:
    """§III.D: ensure every bucket's comm time < the smallest knapsack
    capacity; re-partition any violator."""
    out: List[Bucket] = []
    for b in buckets:
        t = comm_time_of(b.n_elements)
        if t <= max_comm_time or b.n_elements <= 1:
            out.append(b)
            continue
        k = int(t / max_comm_time) + 1
        out.extend(split_bucket(b, k, start_index=0))
    # renumber 1..N preserving order
    return [dataclasses.replace(b, index=i + 1) for i, b in enumerate(out)]


def model_layer_elems(cfg) -> List[int]:
    """Per-'layer' parameter counts in input->output order, including the
    embedding (first) and the head/final norm (last) as their own entries.
    Encoder (enc-dec archs) parameters are appended to the embedding entry:
    their gradients become ready early in backward, like input-side layers."""
    elems = [cfg.embed_params() + cfg.encoder_param_count()]
    elems.extend(cfg.layer_param_counts())
    head = cfg.d_model
    if not cfg.tie_embeddings:
        head += 0  # untied head already counted in embed_params
    elems.append(head)
    return elems


def build_buckets(
    cfg,
    strategy: str = "deft",
    partition_elems: int = 6_500_000,
    comm_time_of=None,
    max_comm_time: float = float("inf"),
) -> List[Bucket]:
    layer_elems = model_layer_elems(cfg)
    if strategy == "uniform":
        return partition_uniform(layer_elems, partition_elems)
    if strategy == "bytescheduler":
        return partition_bytescheduler(layer_elems, partition_elems)
    if strategy == "usbyte":
        return partition_usbyte(layer_elems, partition_elems)
    if strategy == "deft":
        base = partition_usbyte(layer_elems, partition_elems)
        if comm_time_of is None:
            return base
        return apply_deft_constraint(base, comm_time_of, max_comm_time)
    raise ValueError(f"unknown partition strategy {strategy!r}")
