"""Carry parameter trees and decode caches between the JAX package and the
port as numpy.

``params_from_numpy`` takes the JAX package's params as numpy arrays
(``jax.tree.map(np.asarray, params)``) and returns the same nested
dict/tuple tree of torch tensors; ``params_to_numpy`` goes back.  Leaf
order and the stacked per-period shapes are kept, so a ``BucketLayout``
built over either tree is the same layout.  ``cache_from_numpy`` /
``cache_to_numpy`` do the same for a decode cache (``init_cache``'s tree,
JAX's ``init_cache`` tree), keeping each leaf's own dtype: a cache's
recurrent state is f32 whatever the cache's dtype.  Over a mesh with a
'model' axis, ``params_from_numpy(..., mesh=)`` takes this rank's shards.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.sharding.tp import model_specs, shard_params
from repro_torch.tree import tree_map


def params_from_numpy(tree, device="cuda", dtype=torch.float32, *,
                      mesh=None):
    """numpy tree -> torch tree (copies; same structure and shapes).  With
    a ``mesh`` whose 'model' axis is above 1, this rank's shards of the
    global tree instead (``sharding.tp.shard_params`` by
    ``model_specs``)."""
    if mesh is not None and mesh.size("model") > 1:
        tree = shard_params(tree, model_specs(tree, mesh), mesh)
    return tree_map(
        lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device),
        tree,
    )


def params_to_numpy(params):
    """torch tree -> numpy tree (detached host copies)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)


def cache_from_numpy(tree, device="cuda"):
    """numpy cache tree -> torch cache tree, each leaf in its own dtype."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device),
                    tree)


def cache_to_numpy(cache):
    """torch cache tree -> numpy tree of host copies (snapshots: the cache
    is written in place as decoding goes on)."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True).numpy(), cache)
