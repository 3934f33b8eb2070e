"""Carry parameter trees between the JAX package and the port as numpy.

``params_from_numpy`` takes the JAX package's params as numpy arrays
(``jax.tree.map(np.asarray, params)``) and returns the same nested
dict/tuple tree of torch tensors; ``params_to_numpy`` goes back.  Leaf
order and the stacked per-period shapes are kept, so a ``BucketLayout``
built over either tree is the same layout.
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
