"""Carry parameter trees and decode caches between the JAX package and the
port as numpy.

``params_from_numpy`` takes the JAX package's params as numpy arrays
(``jax.tree.map(np.asarray, params)``) and returns the same nested
dict/tuple tree of torch tensors; ``params_to_numpy`` goes back.  Leaf
order and the stacked per-period shapes are kept, so a ``BucketLayout``
built over either tree is the same layout.  ``cache_from_numpy`` /
``cache_to_numpy`` do the same for a decode cache (``init_cache``'s tree,
JAX's ``init_cache`` tree), keeping each leaf's own dtype: a cache's
recurrent state is f32 whatever the cache's dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def params_from_numpy(tree, device="cuda", dtype=torch.float32):
    """numpy tree -> torch tree (copies; same structure and shapes)."""
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
