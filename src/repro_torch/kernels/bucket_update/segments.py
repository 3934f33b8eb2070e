"""Static segment-id map: per-leaf optimizer hyperparameters on flat
bucket buffers.

Port of ``repro/kernels/bucket_update/segments.py`` (numpy only).  Each
bucket buffer concatenates leaf spans plus a zero tail; the update kernel
needs a per-element (lr_scale, weight_decay), constant within a leaf
span.  ``uniform(b)`` is the fast path (one pair for the whole bucket,
passed as kernel arguments); otherwise ``element_hparams(b)`` materializes
the map, tail masked to (0, 0).  ``device_hparams`` keeps the
materialized arrays on the device once per (bucket, device);
``element_hparams_shard`` / ``device_hparams(..., shard=)`` serve one
rank's contiguous span of them on the sharded flat engine.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.optimizers import OptimizerSpec, SegmentHParams, leaf_hparams

if TYPE_CHECKING:
    from repro_torch.train.bucketing import BucketLayout


@dataclasses.dataclass(frozen=True)
class BucketSegments:
    """Frozen per-bucket segment metadata for the update kernel."""

    layout: "BucketLayout"
    hparams: Tuple[SegmentHParams, ...]     # per leaf, tree_flatten order
    _on_device: Dict = dataclasses.field(
        default_factory=dict, compare=False, hash=False, repr=False
    )

    def uniform(self, b: int) -> Optional[Tuple[float, float]]:
        """(lr_scale, weight_decay) if all leaves of bucket ``b`` agree."""
        hps = {
            (self.hparams[i].lr_scale, self.hparams[i].weight_decay)
            for i in self.layout.leaves[b]
        }
        if len(hps) == 1:
            return next(iter(hps))
        return None

    def segment_ids(self, b: int) -> np.ndarray:
        """int32[padded] element -> leaf ordinal within the bucket; the
        padded tail is segment -1."""
        lay = self.layout
        ids = np.full((lay.buf_sizes[b],), -1, np.int32)
        for ordinal, (i, off) in enumerate(zip(lay.leaves[b], lay.offsets[b])):
            n = int(np.prod(lay.shapes[i], dtype=np.int64)) \
                if lay.shapes[i] else 1
            ids[off:off + n] = ordinal
        return ids

    def element_hparams(self, b: int) -> Tuple[np.ndarray, np.ndarray]:
        """The segment-id map as per-element f32 (lr_scale, weight_decay);
        tail elements get scale 0 / wd 0."""
        ids = self.segment_ids(b)
        leaf_ids = self.layout.leaves[b]
        sc = np.array(
            [self.hparams[i].lr_scale for i in leaf_ids] + [0.0], np.float32
        )
        wd = np.array(
            [self.hparams[i].weight_decay for i in leaf_ids] + [0.0],
            np.float32,
        )
        return sc[ids], wd[ids]

    def _span(self, b: int, shard: int, n_shards: int) -> slice:
        """Shard ``shard``'s contiguous span ``[shard * span, (shard + 1) *
        span)`` of bucket ``b``, ``span = buf_sizes[b] // n_shards``."""
        padded = self.layout.buf_sizes[b]
        if padded % n_shards:
            raise ValueError(
                f"bucket {b}: buffer length {padded} does not split into "
                f"{n_shards} shards — build the layout with "
                f"shard_count={n_shards}")
        span = padded // n_shards
        return slice(shard * span, (shard + 1) * span)

    def element_hparams_shard(self, b: int, shard: int, n_shards: int
                              ) -> Tuple[np.ndarray, np.ndarray]:
        """``element_hparams(b)`` sliced to shard ``shard``'s span."""
        sl = self._span(b, shard, n_shards)
        sc, wd = self.element_hparams(b)
        return sc[sl], wd[sl]

    def device_hparams(self, b: int, device, shard: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``element_hparams(b)`` as f32 tensors on ``device`` (cached);
        with ``shard``, views of the layout's span ``shard`` of them (a
        span starts at a multiple of ``shards * 128`` elements, so every
        view is 512-byte aligned)."""
        key = (b, str(device))
        hit = self._on_device.get(key)
        if hit is None:
            sc, wd = self.element_hparams(b)
            hit = (torch.from_numpy(sc).to(device),
                   torch.from_numpy(wd).to(device))
            self._on_device[key] = hit
        if shard is None:
            return hit
        sl = self._span(b, shard, self.layout.shards)
        return tuple(x[sl] for x in hit)


def build_segments(layout: "BucketLayout", spec: OptimizerSpec) -> BucketSegments:
    """Segment metadata for ``layout`` under ``spec``'s per-leaf rules."""
    return BucketSegments(layout=layout,
                          hparams=leaf_hparams(spec, layout.shapes))
