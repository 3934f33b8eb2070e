"""Gradient bucketing over parameter-tree leaves and the static flat-buffer
layout of the replicated engine.

Port of ``repro/train/bucketing.py`` (replicated and sharded layouts,
layout transitions): buckets over the real tree leaves in model
input->output order, filled greedily to ``partition_elems``;
``BucketLayout`` maps every leaf to a span of one flat buffer per bucket,
padded to ``PAD_MULTIPLE`` (times the shard count of the sharded flat
engine, DESIGN.md §8), and carries the per-bucket wire precision policy
(DESIGN.md §13); a ``LayoutTransition`` remaps flat buffers from one
layout of a tree to another (DESIGN.md §9).  Leaf
order is ``jax.tree_util.tree_flatten`` order (``repro_torch.tree``), so
a layout built here equals the JAX package's layout of the same tree.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.bucket import BucketTimes
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.profiler import HardwareModel
from repro_torch.tree import tree_flatten_with_path, tree_leaves

_GROUP_ORDER = {
    "embed": 0,
    "encoder": 1,
    "prefix": 2,
    "stack": 3,
    "tail": 4,
    "final_norm": 5,
    "head": 6,
}

# One f32 lane row of the bucket-update kernels (buffers pad to it).
PAD_MULTIPLE = 128


def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


def ordered_leaf_indices(params) -> List[int]:
    """Indices into tree_flatten(params) leaf order, re-ordered to model
    input->output traversal."""
    keyed = []
    for i, (keys, _) in enumerate(tree_flatten_with_path(params)):
        group = _GROUP_ORDER.get(keys[0], 9)
        sub = 0
        if keys[0] in ("prefix", "stack", "tail") and len(keys) > 1:
            try:
                sub = int(keys[1])
            except ValueError:
                sub = 0
        keyed.append((group, sub, i))
    keyed.sort(key=lambda t: (t[0], t[1]))
    return [i for (_, _, i) in keyed]


def leaf_active_fraction(cfg: ArchConfig, keys: Tuple[str, ...]) -> float:
    """Fraction of a leaf's elements doing matmul work per token (MoE
    routed experts: top-k of E)."""
    if cfg.moe and "experts" in keys and keys[-1] in ("gate", "up", "down"):
        return cfg.moe.experts_per_token / cfg.moe.n_experts
    return 1.0


def greedy_fill_partition(order: Sequence[int], elems: Sequence[int],
                          partition_elems: int) -> Tuple[Tuple[int, ...], int]:
    """Walk ``order``; open a new bucket whenever the running element
    count reaches ``partition_elems``."""
    bucket_of = [0] * len(elems)
    b, acc = 0, 0
    for idx in order:
        bucket_of[idx] = b
        acc += elems[idx]
        if acc >= partition_elems:
            b += 1
            acc = 0
    n_buckets = max(set(bucket_of)) + 1
    return tuple(bucket_of), n_buckets


def assign_buckets(params, cfg: ArchConfig, partition_elems: int = 50_000_000
                   ) -> Tuple[Tuple[int, ...], int]:
    """Greedy fill in model order: (bucket_of_leaf in tree_flatten leaf
    order, n_buckets); bucket 0 is input-most."""
    leaves = tree_leaves(params)
    return greedy_fill_partition(
        ordered_leaf_indices(params), [_numel(l.shape) for l in leaves],
        partition_elems,
    )


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Static mapping between parameter-tree leaves and per-bucket flat
    f32 buffers.

    bucket_of_leaf: leaf index (tree_flatten order) -> bucket id.
    n_buckets:      number of buckets (== number of flat buffers).
    leaves:         per bucket, the leaf indices it holds (ascending).
    offsets:        per bucket, the start offset of each leaf's span.
    sizes:          per bucket, element count of its valid span.
    shapes:         per leaf (tree_flatten order), the original shape.
    padded_sizes:   per bucket, the allocated length (``sizes`` rounded up
                    to a multiple of ``shards`` times the 128-lane width
                    every kernel tiles by; the tail is always zero).
    shards:         shard count of the sharded flat engine: every buffer
                    splits into ``shards`` equal contiguous spans, each a
                    lane-aligned kernel operand.  1 is the replicated
                    engine.
    precision:      per-bucket wire precision policy; ``None`` means
                    all-f32 wires and an f32 master.
    """

    bucket_of_leaf: Tuple[int, ...]
    n_buckets: int
    leaves: Tuple[Tuple[int, ...], ...]
    offsets: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    padded_sizes: Tuple[int, ...]
    shards: int = 1
    precision: Optional[PrecisionPolicy] = None

    def __post_init__(self):
        if any(n % (PAD_MULTIPLE * self.shards) for n in self.padded_sizes):
            raise ValueError(f"bucket buffers {self.padded_sizes} are not all "
                             f"multiples of {self.shards} x {PAD_MULTIPLE} "
                             f"lanes")
        if self.precision is not None:
            self.precision.validate(self.n_buckets)

    @property
    def n_leaves(self) -> int:
        return len(self.bucket_of_leaf)

    def wire(self, b: int) -> str:
        """Wire dtype name of bucket ``b`` ("f32" without a policy)."""
        return "f32" if self.precision is None else self.precision.wire[b]

    @property
    def master_dtype(self) -> str:
        return "f32" if self.precision is None else self.precision.master

    def with_precision(self, precision: Optional[PrecisionPolicy]
                       ) -> "BucketLayout":
        """Same partition, another precision policy."""
        return dataclasses.replace(self, precision=precision)

    @property
    def total_elems(self) -> int:
        return sum(self.sizes)

    @property
    def buf_sizes(self) -> Tuple[int, ...]:
        return self.padded_sizes

    @property
    def shard_sizes(self) -> Tuple[int, ...]:
        """Per bucket, the length of one rank's contiguous span
        (``buf_sizes[b] // shards``, a lane multiple by construction).
        Shard ``s`` of bucket ``b`` covers ``[s * span, (s + 1) * span)``."""
        return tuple(n // self.shards for n in self.buf_sizes)


def build_bucket_layout(params, bucket_of_leaf: Sequence[int], n_buckets: int,
                        *, pad_multiple: int = PAD_MULTIPLE,
                        shard_count: int = 1) -> BucketLayout:
    """Precompute the per-bucket flat-buffer layout of a parameter tree
    (only leaf shapes are read; meta tensors work).

    ``shard_count > 1`` builds the layout of the sharded flat engine:
    every buffer is padded to a multiple of ``shard_count * pad_multiple``
    so it splits into ``shard_count`` equal, lane-aligned spans, and an
    empty bucket still gets one unit so that every span is a non-empty
    kernel and collective operand."""
    if pad_multiple <= 0 or pad_multiple % PAD_MULTIPLE:
        raise ValueError(
            f"pad_multiple={pad_multiple} must be a positive multiple of "
            f"{PAD_MULTIPLE} (the bucket-update kernel's lane width)"
        )
    if shard_count < 1:
        raise ValueError(f"shard_count={shard_count} must be >= 1")
    unit = pad_multiple * shard_count
    flat = tree_leaves(params)
    if len(flat) != len(bucket_of_leaf):
        raise ValueError(f"{len(bucket_of_leaf)} bucket ids for "
                         f"{len(flat)} leaves")
    shapes = tuple(tuple(l.shape) for l in flat)
    leaves: List[List[int]] = [[] for _ in range(n_buckets)]
    for i, b in enumerate(bucket_of_leaf):
        leaves[b].append(i)
    offsets, sizes, padded = [], [], []
    for b in range(n_buckets):
        offs, acc = [], 0
        for i in leaves[b]:
            offs.append(acc)
            acc += _numel(shapes[i])
        offsets.append(tuple(offs))
        sizes.append(acc)
        if acc:
            padded.append(-(-acc // unit) * unit)
        else:
            padded.append(unit if shard_count > 1 else 0)
    return BucketLayout(
        bucket_of_leaf=tuple(bucket_of_leaf),
        n_buckets=n_buckets,
        leaves=tuple(tuple(g) for g in leaves),
        offsets=tuple(offsets),
        sizes=tuple(sizes),
        shapes=shapes,
        padded_sizes=tuple(padded),
        shards=shard_count,
    )


def flatten_bucket(layout: BucketLayout, leaf_vals, b: int) -> torch.Tensor:
    """Bucket ``b``'s flat f32 buffer of leaf values (tree_flatten order),
    zero-padded to the allocated length (a new tensor on the leaves'
    device; a low-precision leaf is promoted exactly)."""
    dev = leaf_vals[0].device if len(leaf_vals) else "cpu"
    buf = torch.zeros((layout.buf_sizes[b],), dtype=torch.float32, device=dev)
    for i, off in zip(layout.leaves[b], layout.offsets[b]):
        n = _numel(layout.shapes[i])
        buf[off:off + n] = leaf_vals[i].reshape(-1)
    return buf


def flatten_buckets(layout: BucketLayout, leaf_vals) -> List[torch.Tensor]:
    """Every bucket's :func:`flatten_bucket`."""
    return [flatten_bucket(layout, leaf_vals, b)
            for b in range(layout.n_buckets)]


def unflatten_buckets(layout: BucketLayout, flats) -> List[torch.Tensor]:
    """Inverse of :func:`flatten_buckets`: per-leaf *views* into the flat
    buffers (tree_flatten order) — writing a view writes the buffer."""
    leaf_vals: List[torch.Tensor] = [None] * layout.n_leaves  # type: ignore
    for b in range(layout.n_buckets):
        for i, off in zip(layout.leaves[b], layout.offsets[b]):
            shape = layout.shapes[i]
            leaf_vals[i] = flats[b][off:off + _numel(shape)].view(shape)
    return leaf_vals


def leaf_bucket_times(params, cfg: ArchConfig, bucket_of_leaf: Sequence[int],
                      n_buckets: int, hw: HardwareModel, seq_len: int,
                      per_device_batch: int) -> BucketTimes:
    """Analytical fwd/bwd/comm seconds per leaf-bucket (same arithmetic, in
    the same order, as the JAX package's per-leaf time model)."""
    tokens = per_device_batch * seq_len
    fwd = [0.0] * n_buckets
    comm_elems = [0] * n_buckets
    for (keys, leaf), b in zip(tree_flatten_with_path(params), bucket_of_leaf):
        n = _numel(tuple(leaf.shape))
        active = leaf_active_fraction(cfg, keys)
        flops = 2.0 * n * active * tokens if len(leaf.shape) >= 2 else 0.0
        fwd[b] += hw.compute_time(flops)
        comm_elems[b] += n
    bwd = [2.0 * f for f in fwd]
    comm = [hw.allreduce_time(e) for e in comm_elems]
    return BucketTimes(tuple(fwd), tuple(bwd), tuple(comm))


def coverage_rescale(times: BucketTimes, coverage_rate: float) -> float:
    """The uniform comm multiplier that pins ``times`` to a target
    coverage rate."""
    return (
        coverage_rate
        * (times.fwd_total + times.bwd_total)
        / max(times.comm_total, 1e-12)
    )


# ---------------------------------------------------------------------------
# Layout transitions (a re-pack between two BucketLayouts of one tree)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SpanCopy:
    """One contiguous copy of a layout transition: ``length`` elements
    from offset ``src_off`` of src bucket ``src_bucket`` land at offset
    ``dst_off`` of the dst bucket this copy belongs to."""

    src_bucket: int
    src_off: int
    dst_off: int
    length: int


@dataclasses.dataclass(frozen=True)
class LayoutTransition:
    """Static per-leaf span remap between two :class:`BucketLayout` s of
    the same parameter tree (DESIGN.md §9): every dst buffer is a
    concatenation of slices of src buffers plus a zero tail.  Adjacent
    leaves contiguous in both layouts merge into one :class:`SpanCopy`, so
    a transition that only changes the shard count is one slice per
    bucket.  ``identical[b]`` marks dst buckets whose buffer equals one src
    buffer (one full-range copy, the same padded length):
    :func:`repack_buffers` returns that src buffer itself."""

    src: BucketLayout
    dst: BucketLayout
    copies: Tuple[Tuple[SpanCopy, ...], ...]   # per dst bucket
    identical: Tuple[bool, ...]                # per dst bucket

    @property
    def moved_elems(self) -> int:
        """Valid elements actually copied (identical buckets excluded)."""
        return sum(
            c.length
            for b, spans in enumerate(self.copies)
            if not self.identical[b]
            for c in spans
        )

    def reverse(self) -> "LayoutTransition":
        return build_layout_transition(self.dst, self.src)


def build_layout_transition(src: BucketLayout, dst: BucketLayout
                            ) -> LayoutTransition:
    """The static span remap ``src`` -> ``dst`` (pure Python over the two
    offset tables).  Both layouts must cover the same leaves (identical
    ``shapes``); bucket count, assignment, padding and shard count may
    differ."""
    if src.shapes != dst.shapes:
        raise ValueError(
            f"layout transition needs the same parameter tree on both "
            f"sides: src has {len(src.shapes)} leaves, dst "
            f"{len(dst.shapes)} (or shapes differ)"
        )
    src_pos: Dict[int, Tuple[int, int]] = {}   # leaf -> (bucket, offset)
    for b in range(src.n_buckets):
        for i, off in zip(src.leaves[b], src.offsets[b]):
            src_pos[i] = (b, off)
    copies: List[Tuple[SpanCopy, ...]] = []
    identical: List[bool] = []
    for b in range(dst.n_buckets):
        spans: List[SpanCopy] = []
        run: Optional[List[int]] = None   # [src_bucket, src_off, dst_off, len]
        for i, d_off in zip(dst.leaves[b], dst.offsets[b]):
            sb, s_off = src_pos[i]
            n = _numel(dst.shapes[i])
            if (run is not None and run[0] == sb
                    and run[1] + run[3] == s_off
                    and run[2] + run[3] == d_off):
                run[3] += n
            else:
                if run is not None:
                    spans.append(SpanCopy(*run))
                run = [sb, s_off, d_off, n]
        if run is not None:
            spans.append(SpanCopy(*run))
        copies.append(tuple(spans))
        identical.append(
            len(spans) == 1
            and spans[0].src_off == 0
            and spans[0].dst_off == 0
            and spans[0].length == dst.sizes[b]
            and src.sizes[spans[0].src_bucket] == dst.sizes[b]
            and src.buf_sizes[spans[0].src_bucket] == dst.buf_sizes[b]
        )
    return LayoutTransition(src=src, dst=dst, copies=tuple(copies),
                            identical=tuple(identical))


def repack_buffers(transition: LayoutTransition,
                   src_bufs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Apply a layout transition to per-bucket buffers, remapped along
    their last axis (1-D buffers and ``(rows, n)`` accumulator stacks
    alike; leading axes pass through).  An identical bucket is the src
    tensor itself; every other is a new tensor of the src dtype whose
    padded tail is zero (src tails, zero by the flat engines' invariant,
    are never read)."""
    dst = transition.dst
    out: List[torch.Tensor] = []
    for b in range(dst.n_buckets):
        if transition.identical[b]:
            out.append(src_bufs[transition.copies[b][0].src_bucket])
            continue
        lead = tuple(src_bufs[0].shape[:-1])
        # the zero fills take the src dtype, so a bf16 buffer stays bf16
        zeros = lambda n: torch.zeros(lead + (n,), dtype=src_bufs[0].dtype,
                                      device=src_bufs[0].device)
        parts: List[torch.Tensor] = []
        cursor = 0
        for c in transition.copies[b]:
            if c.dst_off > cursor:   # cannot happen (offsets are dense)
                parts.append(zeros(c.dst_off - cursor))
            parts.append(src_bufs[c.src_bucket][..., c.src_off:
                                                c.src_off + c.length])
            cursor = c.dst_off + c.length
        if dst.buf_sizes[b] > cursor:
            parts.append(zeros(dst.buf_sizes[b] - cursor))
        if not parts:                # an empty bucket of no length
            parts.append(zeros(0))
        out.append(torch.cat(parts, dim=-1) if len(parts) > 1
                   else parts[0].clone())
    return out
