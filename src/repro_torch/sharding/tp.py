"""Tensor parallelism over the 'model' mesh axis: the port's stand-in for
what XLA's SPMD partitioner inserts where JAX's model code constrains an
activation to a spec over 'model'.

Every model rank holds the same residual stream, and the same gradient
of it.  A sublayer whose weights ``specs.spec_tree`` splits over 'model'
runs between two autograd Functions:

* ``copy_in``: identity forward, all-reduce of the gradient backward
  (each rank's gradient of a replicated input covers only its own
  columns, or its own heads);
* ``reduce_out``: all-reduce forward (the row-parallel product's partial
  sums), identity backward;
* ``gather``: all-gather forward, reduce-scatter backward, for a
  projection split inside a head (qwen3-tiny's kv dim 32 at model 4);
* ``vocab_embed``: the embedding rows of this rank's vocab slice, zero
  elsewhere, summed over 'model';
* ``vocab_parallel_nll``: the cross entropy of logits split over the
  vocab, by a MAX and a SUM all-reduce, the gold logit from the rank that
  holds it.

A leaf ``spec_tree`` keeps whole but that meets a split activation
(qwen3's per-head ``q_norm`` / ``k_norm``, RWKV-6's ddlerp and decay
LoRA, its group-norm scale, a gate block the RG-LRU's 'lru' split falls
inside, the expert leaves where 'experts' does not divide by the model
size) goes in through ``copy_in`` (``owned_part`` takes this rank's
slice of it), so its gradient is summed over 'model' as XLA sums it.
``covering`` gives the span a rank owns and the whole blocks (heads, gate
blocks) that cover it.

Every family runs over 'model': the dense decoders (self-attention over
'heads' / 'kv', the FFN over 'ff', the vocab), the RG-LRU block over
'lru' (its gates over their blocks), RWKV-6's time-mix over its heads and
its channel-mix over 'ff', an encoder-decoder's encoder and
cross-attention, the VLM's gated cross block, MLA over its heads (the
latents whole on every rank) and MoE over its experts (``expert_span``:
routing whole on every rank, each rank running its experts' slots, the
shared experts over 'ff').  ``shard_params`` / ``gather_params`` move a
tree between JAX's global arrays and this rank's shards by ``spec_tree``.
``SpanNorm`` is the clip norm of the flat engines over their gradient
buffers (or this rank's spans of them): the split leaves' squares summed
over 'model', the whole leaves' counted once, JAX's ``global_norm`` of the
global tree.  At model 1 every Function is the identity and issues no
collective (``ModelParallel.of`` gives None, which each helper here takes
as the whole span).
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.sharding import (
    PartitionSpec,
    axis_names,
    rules_deft_manual_dp,
    spec_for,
)
from repro_torch.sharding.specs import spec_tree
from repro_torch.tree import tree_leaves, tree_unflatten

# the ROADMAP entry that every model-axis refusal of an engine or path names
PATHS_ITEM = "ROADMAP item 8.2"


class ModelParallel:
    """This rank's place on the 'model' axis of ``mesh`` and the
    collectives over it, counted in ``calls`` (by kind) and, with
    ``timed`` set, their host seconds in ``seconds`` (the device
    synchronised before and after each, so the time is the
    collective's).  At model 1 every collective is the identity and
    issues nothing."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.group = mesh.group("model")
        self.size = mesh.size("model")
        self.rank = mesh.index("model")
        self._rules = rules_deft_manual_dp()
        self.timed = False
        self.calls: Dict[str, int] = {}
        self.seconds = 0.0

    @classmethod
    def of(cls, mesh) -> Optional["ModelParallel"]:
        """The model axis of ``mesh``, or None where there is none to
        split over (no mesh, or model 1)."""
        if mesh is None or mesh.size("model") == 1:
            return None
        return cls(mesh)

    def reset(self) -> None:
        self.calls = {}
        self.seconds = 0.0

    # ---- what the specs split ---------------------------------------------
    def split(self, name: str, dim: int) -> bool:
        """Whether a dimension of logical ``name`` and size ``dim`` splits
        over 'model' (``spec_for``'s divisibility rule)."""
        spec = spec_for((name,), self._rules, {"model": self.size}, (dim,))
        return spec[0] is not None

    def owned(self, name: str, total: int, unit: int = 1) -> Tuple[int, int]:
        """The slice ``[c0, c1)`` of a dimension this rank owns: its shard
        where the dimension splits, else its share of whole ``unit``s."""
        n, r = self.size, self.rank
        if self.split(name, total):
            c = total // n
            return r * c, (r + 1) * c
        k = total // unit
        return (r * k // n) * unit, ((r + 1) * k // n) * unit

    # ---- collectives -------------------------------------------------------
    def _run(self, kind: str, fn) -> None:
        if self.size == 1:
            return
        self.calls[kind] = self.calls.get(kind, 0) + 1
        if not self.timed:
            fn()
            return
        dev = torch.cuda.is_available() and torch.cuda.is_initialized()
        if dev:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if dev:
            torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM,
                   kind: str = "all_reduce") -> torch.Tensor:
        """In place over 'model', counted under ``kind``; ``x`` must be
        contiguous."""
        self._run(kind, lambda: dist.all_reduce(x, op=op, group=self.group))
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        if self.size == 1:
            return x
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((self.size * src.shape[0],) + src.shape[1:],
                          dtype=src.dtype, device=src.device)
        self._run("all_gather", lambda: dist.all_gather_into_tensor(
            out, src, group=self.group))
        return out.movedim(0, dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's chunk along ``dim`` of every rank's sum of ``x``."""
        if self.size == 1:
            return x
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((src.shape[0] // self.size,) + src.shape[1:],
                          dtype=src.dtype, device=src.device)
        self._run("reduce_scatter", lambda: dist.reduce_scatter_tensor(
            out, src, group=self.group))
        return out.movedim(0, dim)


# ---------------------------------------------------------------------------
# Autograd Functions
# ---------------------------------------------------------------------------
class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mp.all_reduce(g.contiguous().clone()), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        return mp.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp, dim):
        ctx.mp, ctx.dim = mp, dim
        return mp.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mp.reduce_scatter(g, ctx.dim), None, None


# Without a model axis (``mp`` None, or model 1) each of these is the
# identity and issues nothing, so one body of model code serves both.
def copy_in(x: torch.Tensor, mp: Optional[ModelParallel]) -> torch.Tensor:
    return x if mp is None or mp.size == 1 else _CopyIn.apply(x, mp)


def reduce_out(x: torch.Tensor, mp: Optional[ModelParallel]) -> torch.Tensor:
    return x if mp is None or mp.size == 1 else _ReduceOut.apply(x, mp)


def gather(x: torch.Tensor, mp: Optional[ModelParallel],
           dim: int = -1) -> torch.Tensor:
    return (x if mp is None or mp.size == 1
            else _Gather.apply(x, mp, dim % x.ndim))


def covering(mp: Optional[ModelParallel], name: str, total: int, unit: int
             ) -> Tuple[int, int, int, int]:
    """``(c0, c1, u0, u1)``: the slice ``[c0, c1)`` this rank owns of a
    dimension of ``total`` made of ``unit``-wide blocks (heads, gate
    blocks; ``ModelParallel.owned``), and the blocks ``[u0, u1)`` that
    cover it (a split inside a block needs the whole block); all of it
    without ``mp``."""
    c0, c1 = (0, total) if mp is None else mp.owned(name, total, unit)
    return c0, c1, c0 // unit, -(-c1 // unit)


def expert_span(mp: Optional[ModelParallel], n_experts: int
                ) -> Tuple[int, int]:
    """The experts ``[e0, e1)`` this rank runs: its shard where 'experts'
    splits over 'model', else its share of whole experts (a rank may get
    none); all of them without ``mp``."""
    return (0, n_experts) if mp is None else mp.owned("experts", n_experts)


def owned_part(w: torch.Tensor, name: str, total: int, c0: int, c1: int,
               mp: Optional[ModelParallel], dim: int = 0) -> torch.Tensor:
    """``[c0, c1)`` along ``dim`` of a leaf whose dim of logical ``name``
    has ``total`` entries: this rank's shard where that dim splits over
    'model' (``[c0, c1)`` must be the shard), else the whole leaf entered
    through ``copy_in`` (this rank's gradient covers only its slice, so it
    sums over 'model'), sliced; without ``mp`` the leaf's slice."""
    if mp is not None and mp.split(name, total):
        if (c0, c1) != mp.owned(name, total):
            raise ValueError(f"[{c0}, {c1}) is not this rank's shard of "
                             f"{name!r} ({mp.owned(name, total)})")
        return w
    return copy_in(w, mp).narrow(dim, c0, c1 - c0)


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor,
                mp: ModelParallel) -> torch.Tensor:
    """``table`` is this rank's vocab rows ``[rank * Vl, (rank + 1) * Vl)``:
    each token's row where this rank holds it, zeros elsewhere, summed over
    'model' (one nonzero term a token, so the sum is the row exactly)."""
    n = table.shape[0]
    local = tokens.long() - mp.rank * n
    inside = (local >= 0) & (local < n)
    rows = table[torch.where(inside, local, 0)]
    return reduce_out(rows.masked_fill(~inside[..., None], 0.0), mp)


class _VocabParallelNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, mp):
        n = logits.shape[-1]
        top = logits.max(dim=-1).values.contiguous()
        mp.all_reduce(top, dist.ReduceOp.MAX)
        shifted = logits - top[..., None]
        exp = torch.exp(shifted)
        total = exp.sum(dim=-1).contiguous()
        mp.all_reduce(total)
        local = labels.long() - mp.rank * n
        inside = (local >= 0) & (local < n)
        at = torch.where(inside, local, 0)
        gold = torch.gather(logits, -1, at[..., None])[..., 0]
        gold = torch.where(inside, gold, 0.0).contiguous()
        mp.all_reduce(gold)
        ctx.save_for_backward(exp, total, at, inside)
        return torch.log(total) + top - gold

    @staticmethod
    def backward(ctx, g):
        exp, total, at, inside = ctx.saved_tensors
        grad = exp / total[..., None] * g[..., None]
        hit = torch.where(inside, g, 0.0)
        grad.scatter_add_(-1, at[..., None], -hit[..., None])
        return grad, None, None


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                       mp: ModelParallel) -> torch.Tensor:
    """Per-token ``logsumexp(logits) - logits[label]`` of f32 ``logits``
    split over the vocab (this rank's ``[rank * Vl, (rank + 1) * Vl)``):
    the max and the sum of exponentials all-reduced over 'model', the gold
    logit from the rank that holds the label."""
    return _VocabParallelNLL.apply(logits, labels, mp)


# ---------------------------------------------------------------------------
# Placement of parameter trees
# ---------------------------------------------------------------------------
def model_specs(structure, mesh):
    """``spec_tree`` of ``structure`` (global shapes) on ``mesh`` under
    ``rules_deft_manual_dp``, the table JAX's replicated DeFT body runs
    under: every tensor dim over 'model', nothing over the data axes (a
    non-FSDP arch's ``param_rules``)."""
    return spec_tree(structure, rules_deft_manual_dp(), mesh)


def _chunk(spec: PartitionSpec, mesh) -> List[Tuple[int, int, int]]:
    """(dim, chunk index, chunk count) of every split dim of a leaf."""
    out = []
    for d, axis in enumerate(spec):
        names = axis_names(axis)
        if not names:
            continue
        idx, count = 0, 1
        for a in names:
            idx = idx * mesh.size(a) + mesh.index(a)
            count *= mesh.size(a)
        out.append((d, idx, count))
    return out


def shard_params(tree, specs, mesh):
    """This rank's shard of every leaf of ``tree`` (global shapes; torch
    tensors, numpy arrays or meta tensors) by ``specs``: views where the
    leaf is a tensor."""
    def take(leaf, spec):
        for d, idx, count in _chunk(spec, mesh):
            n = leaf.shape[d] // count
            sl = [slice(None)] * leaf.ndim
            sl[d] = slice(idx * n, (idx + 1) * n)
            leaf = leaf[tuple(sl)]
        return leaf

    return tree_unflatten(tree, [take(x, s) for x, s in
                                 zip(tree_leaves(tree), tree_leaves(specs))])


def gather_params(tree, specs, mp: ModelParallel):
    """The global tree of this rank's shards ``tree`` (torch tensors), each
    split leaf all-gathered over 'model' (a collective every model rank
    calls); a leaf split over another axis is refused."""
    out = []
    for leaf, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        for d, axis in enumerate(spec):
            if not axis_names(axis):
                continue
            if axis_names(axis) != ("model",):
                raise ValueError(f"gather_params gathers over 'model' only, "
                                 f"not {spec}")
            leaf = mp.all_gather(leaf.detach(), d)
        out.append(leaf)
    return tree_unflatten(tree, out)


def global_norm(tensors, *, split, mp: ModelParallel) -> torch.Tensor:
    """The global norm of gradient leaves (tree_flatten order) of which
    ``split`` marks this rank's shards: their squares summed over
    'model', the replicated leaves' counted once, as JAX's ``global_norm``
    of the global tree (the DDP baseline's, over its gradient tree)."""
    sq = [torch.sum(torch.square(x.float())) for x in tensors]
    zero = torch.zeros((), dtype=torch.float32, device=sq[0].device)
    part = [q for q, s in zip(sq, split) if s]
    rest = [q for q, s in zip(sq, split) if not s]
    part = torch.sum(torch.stack(part)).reshape(1) if part else zero.reshape(1)
    mp.all_reduce(part)
    rest = torch.sum(torch.stack(rest)) if rest else zero
    return torch.sqrt(part[0] + rest)


class SpanNorm:
    """The clip norm of a flat engine's gradient buffers at model > 1.

    ``runs[b]`` lists bucket ``b``'s stretches ``(start, end, split)`` of
    leaves that ``split`` marks alike (adjacent leaves merged, the
    padding left out), from the layout's offsets.  A call takes the
    buffers, or this rank's spans of them (``shard_id``: span ``b`` starts
    at ``shard_id * len(gbuf[b])``), and sums the squares of the scaled
    elements that fall in split stretches and in whole ones, as two
    numbers: no leaf is copied, and no mask is built.  ``psum`` (the
    sharded engine's 'data' sum) adds the pair over the spans, then the
    split part is summed over 'model' (one all-reduce of one element), so
    that ``sqrt(split + whole)`` is JAX's ``global_norm`` of the global
    tree."""

    def __init__(self, layout, split: Sequence[bool], mp: ModelParallel):
        self.mp = mp
        runs = []
        for b in range(layout.n_buckets):
            out: List[List] = []
            for i, off in zip(layout.leaves[b], layout.offsets[b]):
                end = off + math.prod(layout.shapes[i])
                if out and out[-1][2] == split[i] and out[-1][1] == off:
                    out[-1][1] = end
                else:
                    out.append([off, end, bool(split[i])])
            runs.append(tuple(tuple(r) for r in out))
        self.runs = tuple(runs)

    def __call__(self, gbuf: Sequence[torch.Tensor], *, grad_scale=1.0,
                 shard_id: Optional[int] = None,
                 psum: Optional[Callable] = None) -> torch.Tensor:
        dev = gbuf[0].device
        acc = [torch.zeros((), dtype=torch.float32, device=dev)
               for _ in range(2)]
        for b, g in enumerate(gbuf):
            lo = 0 if shard_id is None else shard_id * g.numel()
            hi = lo + g.numel()
            for a, e, s in self.runs[b]:
                a, e = max(a, lo), min(e, hi)
                if a < e:
                    part = g[a - lo:e - lo] * grad_scale
                    acc[s] = acc[s] + torch.sum(torch.square(part))
                    del part
        pair = torch.stack([acc[1], acc[0]])          # (split, whole)
        if psum is not None:
            psum(pair)
        split = pair[:1].clone()
        self.mp.all_reduce(split)
        return torch.sqrt(split[0] + pair[1])


def shared_rows(runs, lanes: int = 128) -> Tuple[Tuple[int, ...], ...]:
    """Per bucket, the ``lanes``-wide rows of its buffer that hold
    elements of a split leaf and of a whole one, from ``SpanNorm.runs``:
    the rows whose int8 scale, a row's own absmax, would differ between
    the model ranks and move the whole leaf's rounding with it."""
    out = []
    for bucket in runs:
        # a row inside a stretch holds only that stretch's kind, so only
        # a stretch's first and last rows can be shared
        has = (set(), set())
        for a, e, split in bucket:
            has[split].update((a // lanes, (e - 1) // lanes))
        out.append(tuple(sorted(has[0] & has[1])))
    return tuple(out)


def hash_segments(layout, global_layout, specs, mesh
                  ) -> Tuple[Tuple[Tuple[int, int, int, int], ...], ...]:
    """Per bucket of ``layout`` (built over this rank's shards), where its
    leaves sit in ``global_layout`` (the same buckets over the global
    tree): one ``(start, inner, position, stride)`` row a leaf, sorted by
    ``start``, the table of ``kernels.quantize.HashIndex``.  A leaf split
    along dim ``d`` into ``count`` chunks of which this rank holds chunk
    ``k`` is ``prod(shape[:d])`` runs of ``inner`` elements, ``stride``
    apart in the global leaf, from ``k * inner``; a whole leaf is one run.
    The stochastic-rounding hash then reads each element at its place in
    JAX's global bucket, so a split leaf's bits are the one-device run's
    and a whole leaf's are the same on every model rank."""
    spec_of = tree_leaves(specs)
    out = []
    for b in range(layout.n_buckets):
        rows = []
        for i, lo, go in zip(layout.leaves[b], layout.offsets[b],
                             global_layout.offsets[b]):
            shape = global_layout.shapes[i]
            n = math.prod(layout.shapes[i])
            chunks = _chunk(spec_of[i], mesh) if n else []
            if len(chunks) > 1:
                raise ValueError(f"leaf {i} is split along {len(chunks)} "
                                 f"dims; the hash table maps one")
            if not chunks:
                rows.append((lo, max(n, 1), go, 0))
                continue
            d, k, _ = chunks[0]
            inner = n // math.prod(shape[:d])
            rows.append((lo, inner, go + k * inner,
                         math.prod(shape[d:])))
        out.append(tuple(rows))
    return tuple(out)


def split_leaves(specs) -> Tuple[bool, ...]:
    """Per leaf (tree_flatten order), whether ``specs`` splits it over
    'model': its gradient is a shard, and its squared norm sums over
    'model'."""
    return tuple(any("model" in axis_names(a) for a in spec)
                 for spec in tree_leaves(specs))



