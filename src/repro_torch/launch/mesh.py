"""Meshes of process groups, per-link communication chains and the
elastic group of the port (DESIGN.md §10, §14).

``make_debug_mesh`` / ``make_production_mesh`` are the counterparts of
``repro/launch/mesh.py``'s: a :class:`Mesh` over the ranks of the
initialised process group, rank ``(p * data + d) * model + m`` at pod
``p``, data position ``d``, model position ``m`` (the row-major device
order of ``jax.make_mesh``), with one process group per line of each axis,
built in the same order on every rank.  Copies of ``ring_chain`` and
``link_chains`` from the JAX module: a chain is a permutation of the
positions of the 'data' process group; ``train/chains.py`` runs the
secondary link's reduce-scatter and all-gather as point-to-point rounds
along it.  ``elastic_group`` is the process-group counterpart of the JAX
module's ``make_elastic_mesh``.
"""
from __future__ import annotations

import itertools
import math
import os
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.distributed as dist


class Mesh:
    """Named axes over the ranks of the process group: their sizes, this
    rank's coordinates, and the process group of this rank's line along
    each axis (``group(axis)``; None where the line is the whole world,
    so a one-axis mesh runs its collectives on the default group, and for
    an axis of size 1 other than 'data', which has no collective to run).
    ``dp_group`` is the joint ('pod', 'data') group of this rank's model
    position: the group a replicated leaf's gradient is summed over.
    ``shape`` is ``{axis: size}``, as JAX's ``Mesh.shape``."""

    def __init__(self, axis_names: Sequence[str], axis_sizes: Sequence[int]):
        if not dist.is_initialized():
            raise RuntimeError("a Mesh spans the ranks of an initialised "
                               "process group")
        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(int(n) for n in axis_sizes)
        world, rank = dist.get_world_size(), dist.get_rank()
        if any(n < 1 for n in self.axis_sizes) \
                or math.prod(self.axis_sizes) != world:
            raise ValueError(f"a {dict(self.shape)} mesh does not cover the "
                             f"{world} ranks of the process group")
        coords, rest = [], rank
        for n in reversed(self.axis_sizes):
            coords.append(rest % n)
            rest //= n
        self.coords = tuple(reversed(coords))
        self._groups: Dict[Tuple[str, ...], Any] = {}
        for axis, n in zip(self.axis_names, self.axis_sizes):
            self._groups[(axis,)] = (self._build((axis,))
                                     if n > 1 or axis == "data" else None)
        dp = tuple(a for a in ("pod", "data") if a in self.axis_names)
        self._groups[dp] = (self._groups[dp] if dp in self._groups
                            else self._build(dp))
        self.dp_group = self._groups[dp]

    def _build(self, axes: Tuple[str, ...]):
        """Every rank's line over ``axes`` (the other coordinates fixed),
        one ``dist.new_group`` each in row-major order of the other
        coordinates: this rank's, or None when a line is the world."""
        world, rank = dist.get_world_size(), dist.get_rank()
        others = [i for i, a in enumerate(self.axis_names) if a not in axes]
        along = [self.axis_names.index(a) for a in axes]
        mine = None
        for fixed in itertools.product(*(range(self.axis_sizes[i])
                                         for i in others)):
            coord = dict(zip(others, fixed))
            ranks = []
            for pos in itertools.product(*(range(self.axis_sizes[i])
                                           for i in along)):
                coord.update(zip(along, pos))
                r = 0
                for i, n in enumerate(self.axis_sizes):
                    r = r * n + coord[i]
                ranks.append(r)
            if len(ranks) == world:
                return None
            g = dist.new_group(ranks)
            if rank in ranks:
                mine = g
        return mine

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def size(self, axis: str) -> int:
        """The size of ``axis`` (1 when the mesh lacks it)."""
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's position on ``axis`` (0 when the mesh lacks it)."""
        if axis not in self.axis_names:
            return 0
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        """This rank's line along ``axis`` (None: the world); a mesh
        without ``axis`` has none."""
        if axis not in self.axis_names:
            return None
        return self._groups[(axis,)]

    @property
    def dp_size(self) -> int:
        """Ranks of one model position: pod x data."""
        return self.size("pod") * self.size("data")

    @property
    def dp_index(self) -> int:
        """This rank's position over ('pod', 'data'): the slice of the
        global batch it takes."""
        return self.index("pod") * self.size("data") + self.index("data")

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self.coords})"


def make_debug_mesh(data: int = 4, model: int = 2, pod: int = 0) -> Mesh:
    """A (data, model) mesh, or (pod, data, model) with ``pod``, over the
    ranks of the process group (JAX's builds it over forced host devices)."""
    if pod:
        return Mesh(("pod", "data", "model"), (pod, data, model))
    return Mesh(("data", "model"), (data, model))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """JAX's production mesh is a 16 x 16 v5e pod, (data 16, model 16), or
    two of them as (pod 2, data 16, model 16): the 'model' axis is one
    pod's fast ICI dimension.  On GPUs the fast domain is a node's NVLink,
    so the port maps it to ``(world / g, g)``, ``g`` the GPUs of a node
    (torchrun's ``LOCAL_WORLD_SIZE``, else the node's visible cards), and
    ``multi_pod`` to ``(2, world / (2 g), g)``.
    """
    world = dist.get_world_size()
    g = int(os.environ.get("LOCAL_WORLD_SIZE",
                           torch.cuda.device_count() or 1))
    pods = 2 if multi_pod else 1
    if world % (pods * g):
        raise ValueError(f"{world} ranks do not split into {pods} pod(s) "
                         f"of nodes of {g} GPUs")
    return make_debug_mesh(data=world // (pods * g), model=g,
                           pod=pods if multi_pod else 0)


def elastic_group(ranks: Sequence[int]):
    """The process group of the surviving shards' global ``ranks``, in
    origin order (ascending): the 'data' group an elastic migration
    spawns its runtime over (``make_elastic_mesh`` builds a mesh of the
    surviving data rows instead).  ``dist.new_group`` is collective over
    the world, so every rank calls this with the same ``ranks`` in the
    same order of calls; a rank outside them gets
    ``GroupMember.NON_GROUP_MEMBER`` and must build no runtime over it.
    The elastic coordinator builds one group per membership and reuses it
    when that membership comes back."""
    ranks = [int(r) for r in ranks]
    if not ranks or ranks != sorted(set(ranks)):
        raise ValueError(f"elastic_group needs ascending distinct ranks, "
                         f"got {ranks}")
    return dist.new_group(ranks)


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
