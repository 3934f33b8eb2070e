"""Lazy per-bucket parameter streaming for the decoupled sharded engine.

Port of ``repro/train/streaming.py`` (DESIGN.md §12).  The sharded flat
engine re-materializes every bucket's full param buffer from the spans
before the forward: one all-gather burst at phase start.  The decoupled
engine hands ``loss_fn`` a lazy view of the parameter tree instead, and a
bucket's buffer is materialized at the first forward access of any leaf
it holds.  JAX streams by trace order; eager PyTorch streams by run
order, so ``ParamStream`` issues the gathers itself:

* each gather is issued asynchronously one bucket ahead of its first
  use, in the order the buckets were first touched on the cycle
  position's first dispatch (the forward is static, so the order is);
* the first touch waits for the bucket's gather and decodes it (an int8
  gather is quantize and two all-gathers at issue, dequantize at the
  wait); a bucket whose gather the gather skip reuses reads the cache;
* a gather routed onto a ring chain runs synchronously at first touch,
  after every gather in flight has landed;
* a bucket the forward never touches is gathered after the forward, so
  the gather cache holds every bucket.

A leaf is built as the burst engine builds it (``runtime._grad_leaves``):
a view of the gathered buffer whose ``.grad`` views the gradient buffer,
so the gradients land packed and the result is bitwise the burst
engine's.  Leaves are memoized, so a tied embedding read again by the LM
head is the same tensor.  ``repro_torch.tree`` walks the lazy containers
like dicts and tuples: ``tree_leaves`` or ``tree_dense`` of a subtree
materializes exactly that subtree, which is what the model does at a
checkpoint boundary and before the stacked layers (JAX's ``lax.scan``).
"""
from __future__ import annotations

from collections.abc import Mapping, Sequence
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.bucketing import BucketLayout
from repro_torch.tree import tree_unflatten

# gathers in flight ahead of the bucket the forward waits for: one keeps
# at most two gathered buffers arriving at once
AHEAD = 1


class _BucketLoader:
    """Leaf index -> leaf tensor, memoized, from ``get_full(b)`` (bucket
    ``b``'s full flat buffer, asked for once).  With ``grads`` (per-bucket
    gradient buffers) a leaf is a fresh autograd leaf whose ``.grad`` views
    its span of ``grads[b]``; without, a plain view of the buffer."""

    __slots__ = ("layout", "get_full", "grads", "_pos", "_full", "_leaves")

    def __init__(self, layout: BucketLayout, get_full: Callable,
                 grads: Optional[Sequence[torch.Tensor]] = None):
        self.layout = layout
        self.get_full = get_full
        self.grads = grads
        self._pos = {i: off for b in range(layout.n_buckets)
                     for i, off in zip(layout.leaves[b], layout.offsets[b])}
        self._full: Dict[int, torch.Tensor] = {}
        self._leaves: Dict[int, torch.Tensor] = {}

    def leaf(self, i: int) -> torch.Tensor:
        hit = self._leaves.get(i)
        if hit is not None:
            return hit
        b = self.layout.bucket_of_leaf[i]
        full = self._full.get(b)
        if full is None:
            full = self._full[b] = self.get_full(b)
        off = self._pos[i]
        shape = self.layout.shapes[i]
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        val = full[off:off + n].view(shape)
        if self.grads is not None:
            val = val.detach().requires_grad_(True)
            val.grad = self.grads[b][off:off + n].view(shape)
        self._leaves[i] = val
        return val


def _resolve(node, loader: _BucketLoader):
    """One lazy step: containers stay lazy, a leaf index materializes."""
    if isinstance(node, dict):
        return LazyDict(node, loader)
    if isinstance(node, (tuple, list)):
        return LazyList(node, loader)
    return loader.leaf(node)


class LazyDict(Mapping):
    """Dict-shaped lazy view; ``[]`` resolves one level lazily."""

    __slots__ = ("_node", "_loader")

    def __init__(self, node, loader):
        self._node = node
        self._loader = loader

    def __getitem__(self, key):
        return _resolve(self._node[key], self._loader)

    def __contains__(self, key):
        return key in self._node

    def __len__(self):
        return len(self._node)

    def __iter__(self):
        return iter(self._node)


class LazyList(Sequence):
    """Tuple-shaped lazy view; ``[i]`` and iteration resolve lazily."""

    __slots__ = ("_node", "_loader")

    def __init__(self, node, loader):
        self._node = node
        self._loader = loader

    def __getitem__(self, i):
        if isinstance(i, slice):
            return LazyList(tuple(self._node[i]), self._loader)
        return _resolve(self._node[i], self._loader)

    def __len__(self):
        return len(self._node)

    def __iter__(self):
        return (_resolve(v, self._loader) for v in self._node)


def lazy_param_tree(structure, layout: BucketLayout, get_full: Callable,
                    grads: Optional[Sequence[torch.Tensor]] = None):
    """Lazy parameter-tree view over per-bucket flat buffers.

    ``structure`` is a tree of the parameters' shape (meta tensors do),
    ``get_full(b)`` returns bucket ``b``'s full flat buffer (called at
    most once per bucket, at the first access of a leaf it holds) and
    ``grads`` wires each leaf's ``.grad`` into the gradient buffers."""
    index_tree = tree_unflatten(structure, list(range(layout.n_leaves)))
    return _resolve(index_tree, _BucketLoader(layout, get_full, grads))


class ParamStream:
    """Per-bucket full param buffers for one phase, gathered as the
    forward first touches them.

    ``start(b)`` issues bucket ``b``'s gather and returns the function that
    waits for it and returns the decoded full buffer; ``cached[b]`` is the
    buffer of a bucket whose gather is reused (None: gather it);
    ``chained[b]`` marks a gather that runs synchronously at first touch;
    ``order`` is the first-touch order of an earlier dispatch (None: issue
    nothing ahead)."""

    def __init__(self, start: Callable[[int], Callable[[], torch.Tensor]],
                 cached: Sequence[Optional[torch.Tensor]],
                 chained: Optional[Sequence[bool]] = None,
                 order: Optional[Sequence[int]] = None):
        nb = len(cached)
        self._start = start
        self._cached = cached
        self._chained = (tuple(chained) if chained is not None
                         else (False,) * nb)
        ahead = [b for b in (order or ()) if cached[b] is None
                 and not self._chained[b]]
        self._next = {b: ahead[k + 1:k + 1 + AHEAD]
                      for k, b in enumerate(ahead)}
        self._pending: Dict[int, Callable[[], torch.Tensor]] = {}
        self._full: Dict[int, torch.Tensor] = {}
        self.touched: List[int] = []
        self.issued: List[int] = []
        self.issued_at_first_touch: Optional[int] = None

    def _issue(self, b: int) -> None:
        if b not in self._pending and b not in self._full:
            self.issued.append(b)
            self._pending[b] = self._start(b)

    def _land(self, b: int) -> torch.Tensor:
        if b not in self._full:
            if self._cached[b] is not None:
                self._full[b] = self._cached[b]
            elif self._chained[b]:
                for p in list(self._pending):      # nothing else in flight
                    self._land(p)
                self.issued.append(b)
                self._full[b] = self._start(b)()
            else:
                self._issue(b)
                self._full[b] = self._pending.pop(b)()
        return self._full[b]

    def get_full(self, b: int) -> torch.Tensor:
        """Bucket ``b``'s full buffer; its first call is the bucket's first
        touch: it issues the gathers ahead of ``b`` first."""
        if b in self._full:
            return self._full[b]
        self.touched.append(b)
        if self._cached[b] is None and not self._chained[b]:
            self._issue(b)
            for nxt in self._next.get(b, ()):
                self._issue(nxt)
        full = self._land(b)
        if self.issued_at_first_touch is None:
            self.issued_at_first_touch = len(self.issued)
        return full

    def complete(self) -> Tuple[torch.Tensor, ...]:
        """Every bucket's full buffer: the gathers in flight land and a
        bucket the forward never touched is gathered now."""
        return tuple(self._land(b) for b in range(len(self._cached)))
