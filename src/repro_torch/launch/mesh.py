"""Per-link communication chains of the port (DESIGN.md §14).

Copies of ``ring_chain`` and ``link_chains`` from ``repro/launch/mesh.py``
(that module builds JAX meshes, so the port takes these two functions and
not the module).  A chain is a permutation of the positions of the
'data' process group; ``train/chains.py`` runs the secondary link's
reduce-scatter and all-gather as point-to-point rounds along it.
"""
from __future__ import annotations


def ring_chain(n: int, link: int) -> tuple:
    """Device-order chain (axis indices, DeAR-style ring reordering) for
    ``link`` over ``n`` data-parallel positions.

    Link 0 is the natural axis order — the ordering XLA's single-axis
    collectives already use, so primary traffic keeps its fabric.  Link
    ``l`` > 0 interleaves with stride ``l + 1`` (evens-then-odds for the
    first secondary link: ``[0, 2, ..., 1, 3, ...]``), which on a
    multi-NIC torus maps neighbor hops onto a *different* physical cable
    set than the natural ring — the DeAR observation that decoupled
    stages on distinct device orders stop contending for the same links.
    Falls back to a rotation when the stride pattern degenerates (it
    never does for n >= 3, but n <= 2 has only one ring)."""
    if n <= 0:
        raise ValueError(f"ring_chain needs n >= 1, got {n}")
    if link <= 0 or n <= 2:
        return tuple(range(n))
    stride = link + 1
    chain = [p for s in range(stride) for p in range(s, n, stride)]
    if len(set(chain)) != n:
        chain = [(p + link) % n for p in range(n)]
    return tuple(chain)


def link_chains(n: int, n_links: int = 2) -> dict:
    """``{link_id: chain}`` for every link — the topology input the
    runtime's chain collectives and the planner's per-link pricing
    share."""
    return {link: ring_chain(n, link) for link in range(n_links)}
