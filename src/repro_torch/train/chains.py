"""Per-link ring-chain collectives of the port (DESIGN.md §14).

Port of ``repro/train/chains.py`` over a ``torch.distributed`` process
group.  A bucket the planner put on the secondary link runs its
reduce-scatter and all-gather as point-to-point rounds along that link's
chain (``launch.mesh.ring_chain``: a permutation of the group's ranks)
instead of the group's own collectives, so its neighbour hops take other
wires than the natural ring.  Each round is one ``batch_isend_irecv``;
``record`` receives its ``(source, destination)`` pairs (group ranks,
as ``chain_perm`` gives them), which is how a test sees that the traffic
left the natural ring.

The algorithm is the JAX package's, not NCCL's ring, so the results are
bitwise the JAX chain's:

* ``chain_reduce_scatter`` ships raw chunks over ``n - 1`` jump-``s``
  rounds (round ``s`` sends each rank's chunk for the rank ``s`` chain
  hops ahead) and sums locally in ascending rank order,
  ``((c0 + c1) + c2) + ...``;
* ``chain_all_gather`` is a store-and-forward relay along the chain;
* ``chain_all_reduce`` zero-pads to a multiple of the chain length and
  composes the two.

At ``n == 1`` all three return the input and issue no P2P op.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Perm = Tuple[Tuple[int, int], ...]
Record = Optional[Callable[[Perm], None]]


def chain_perm(chain: Sequence[int], jump: int = 1) -> Perm:
    """The permutation moving data ``jump`` hops forward along ``chain``
    (source, destination) — ``jump=1`` is the ring."""
    n = len(chain)
    return tuple((chain[p], chain[(p + jump) % n]) for p in range(n))


def _position(chain: Sequence[int], group) -> Tuple[int, int]:
    """(chain length, this rank's position on the chain); a chain that
    does not cover the group raises."""
    n = len(chain)
    size = dist.get_world_size(group)
    if n != size or sorted(chain) != list(range(n)):
        raise ValueError(
            f"chain {tuple(chain)} is not a permutation of the {size} ranks "
            f"of its process group")
    return n, list(chain).index(dist.get_rank(group))


def _exchange(send: torch.Tensor, dst: int, recv: torch.Tensor, src: int,
              group) -> None:
    """One round: send ``send`` to group rank ``dst`` while receiving
    ``recv`` from group rank ``src`` (P2P peers are global ranks)."""
    peer = ((lambda r: r) if group is None
            else (lambda r: dist.get_global_rank(group, r)))
    ops = [dist.P2POp(dist.isend, send, peer(dst), group),
           dist.P2POp(dist.irecv, recv, peer(src), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()


def chain_reduce_scatter(x: torch.Tensor, chain: Sequence[int], group=None,
                         record: Record = None) -> torch.Tensor:
    """This rank's chunk of the ranks' sum of the flat buffer ``x`` (whose
    length the chain length divides), reduced in ascending rank order
    after ``n - 1`` rounds that each move one raw chunk per rank."""
    n, pos = _position(chain, group)
    if n == 1:
        return x
    if x.numel() % n:
        raise ValueError(f"chain_reduce_scatter: {x.numel()} elements do not "
                         f"split over a chain of {n}")
    xt = x.reshape(n, -1)
    me = chain[pos]
    parts = [None] * n
    parts[me] = xt[me]
    for s in range(1, n):
        src = chain[(pos - s) % n]
        parts[src] = torch.empty_like(xt[me])
        _exchange(xt[chain[(pos + s) % n]], chain[(pos + s) % n],
                  parts[src], src, group)
        if record is not None:
            record(chain_perm(chain, s))
    acc = parts[0]
    for d in range(1, n):
        acc = acc + parts[d]
    return acc


def chain_all_gather(x: torch.Tensor, chain: Sequence[int], group=None,
                     out: Optional[torch.Tensor] = None,
                     record: Record = None) -> torch.Tensor:
    """Every rank's flat ``x`` concatenated in rank order (into ``out``
    when given): each round every rank forwards along the chain the chunk
    it received the round before, straight into its slot of ``out``."""
    n, pos = _position(chain, group)
    if n == 1:
        if out is None:
            return x
        return out if out.data_ptr() == x.data_ptr() else out.copy_(x)
    if out is None:
        out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    slots = out.view(n, -1)
    cur = chain[pos]
    slots[cur].copy_(x.reshape(-1))
    for s in range(1, n):
        src = chain[(pos - s) % n]
        _exchange(slots[cur], chain[(pos + 1) % n], slots[src],
                  chain[(pos - 1) % n], group)
        cur = src
        if record is not None:
            record(chain_perm(chain, 1))
    return out


def chain_all_reduce(x: torch.Tensor, chain: Sequence[int], group=None,
                     record: Record = None) -> torch.Tensor:
    """The ranks' sum of the contiguous ``x``, written into ``x``: a chain
    reduce-scatter then all-gather of ``x`` zero-padded to a multiple of
    the chain length (padding never mixes into real lanes)."""
    n, _ = _position(chain, group)
    if n == 1:
        return x
    flat = x.view(-1)
    pad = (-flat.numel()) % n
    src = torch.cat([flat, flat.new_zeros(pad)]) if pad else flat
    shard = chain_reduce_scatter(src, chain, group, record)
    chain_all_gather(shard, chain, group, out=src, record=record)
    if pad:
        flat.copy_(src[:flat.numel()])
    return x
