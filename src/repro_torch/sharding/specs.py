"""Parameter / batch PartitionSpecs per architecture and mode.

Port of ``repro/sharding/specs.py`` (that module imports jax, so the port
keeps its own copy of ``_base_axes``): every parameter leaf gets
*logical* axis names from its key path (the naming convention of the
models), and ``spec_tree`` resolves them through a rule table against a
mesh, dropping any axis whose dimension does not divide the mesh axis
product (36 heads over a 16-way 'model' axis -> replicated heads, sharded
FFN; seamless's 256206 vocab -> replicated embedding).  A mesh is a
mapping ``{axis: size}`` or an object whose ``shape`` is one
(``launch.mesh.Mesh``).  ``sharding/tp.py`` places each leaf by its spec.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

from repro_torch.sharding import AxisVal, PartitionSpec, needs_fsdp
from repro_torch.tree import tree_flatten_with_path, tree_unflatten


# --------------------------------------------------------------------------
# Logical axes per parameter leaf
# --------------------------------------------------------------------------
def _base_axes(path: Tuple[str, ...], ndim: int) -> Tuple[Optional[str], ...]:
    """Logical dim names for a leaf, from its path (innermost name +
    context), EXCLUDING any stacked leading period dim."""
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    in_ffn = "ffn" in path or "shared" in path
    axes: Tuple[Optional[str], ...]

    if name == "table":
        axes = ("vocab", "embed")
    elif parent == "head" and name == "w":
        axes = ("embed", "vocab")
    elif parent == "experts" and name in ("gate", "up"):  # MoE [E, d, de]
        axes = ("experts", "embed", None)
    elif parent == "experts" and name == "down":
        axes = ("experts", None, "embed")
    elif name in ("gate", "up"):
        axes = ("embed", "ff")
    elif name == "down":
        axes = ("ff", "embed")
    elif name == "router":
        axes = ("embed", None)
    elif name == "wq":
        axes = ("embed", "heads")
    elif name in ("wk", "wv") and in_ffn:             # rwkv channel-mix
        axes = ("embed", "ff") if name == "wk" else ("ff", "embed")
    elif name in ("wk", "wv"):
        axes = ("embed", "kv")
    elif name in ("wr", "wg"):                         # rwkv projections
        axes = ("embed", "heads")
    elif name == "wo":
        axes = ("heads", "embed")
    elif name in ("wx", "wgate"):                      # rglru in-projections
        axes = ("embed", "lru")
    elif name in ("wdq", "wdkv"):                      # MLA down-projections
        axes = ("embed", None)
    elif name in ("wuq", "wuk", "wuv"):                # MLA up-projections
        axes = (None, "heads")
    elif name == "conv_w":
        axes = (None, "lru")
    elif name in ("conv_b", "a_param"):
        axes = ("lru",)
    elif name in ("w_rgate", "w_igate"):
        axes = ("heads", None, None)
    elif name == "ddlerp_a":
        axes = ("embed", None)
    elif name == "ddlerp_b":
        axes = (None, None, "embed")
    elif name == "w_lora_a":
        axes = ("embed", None)
    elif name == "w_lora_b":
        axes = (None, "embed")
    elif name == "u":
        axes = ("heads", None)
    elif name == "mu_base":
        axes = (None, "embed")
    elif name == "w0":
        axes = ("embed",)
    else:
        axes = tuple([None] * ndim)  # norms, gates, scalars

    # stacked scan leaves carry a leading period dim
    if len(axes) == ndim - 1:
        axes = (None,) + axes
    if len(axes) != ndim:
        axes = tuple([None] * ndim)
    return axes


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a mesh given as that mapping or as an object
    with a ``shape`` mapping."""
    shape = mesh if isinstance(mesh, Mapping) else mesh.shape
    return {str(k): int(v) for k, v in dict(shape).items()}


def _mesh_axis_size(shape: Dict[str, int], axis: AxisVal) -> int:
    if axis is None:
        return 1
    names = (axis,) if isinstance(axis, str) else axis
    return int(math.prod(shape[n] for n in names))


def leaf_spec(path: Tuple[str, ...], shape: Tuple[int, ...],
              rules: Dict[str, AxisVal], mesh) -> PartitionSpec:
    sizes = mesh_shape(mesh)
    axes = _base_axes(tuple(path), len(shape))
    out = []
    for dim, name in zip(shape, axes):
        mapped = rules.get(name) if name else None
        if mapped is not None and dim % _mesh_axis_size(sizes, mapped) != 0:
            mapped = None  # divisibility fallback -> replicate this dim
        out.append(mapped)
    return PartitionSpec(*out)


def spec_tree(tree, rules: Dict[str, AxisVal], mesh):
    """PartitionSpec tree for a parameter (or optimizer-state) tree; only
    the leaves' shapes are read (meta tensors work)."""
    return tree_unflatten(tree, [
        leaf_spec(path, tuple(leaf.shape), rules, mesh)
        for path, leaf in tree_flatten_with_path(tree)])


# --------------------------------------------------------------------------
# Per-arch distribution policy
# --------------------------------------------------------------------------
def param_rules(arch_name: str, multi_pod: bool, layout: str = "tp"
                ) -> Dict[str, AxisVal]:
    """Rules used for *parameter storage* shardings.

    layout='tp'  — tensor-parallel over 'model' (default; FSDP over 'data'
                   for the three giant archs).
    layout='dp'  — pure data parallelism: weights fully replicated, batch
                   over every mesh axis.
    """
    del multi_pod       # the JAX signature's; no parameter rule reads it
    if layout == "dp":
        if needs_fsdp(arch_name):
            raise ValueError("dp layout cannot replicate >90B")
        return {k: None for k in
                ("embed", "heads", "kv", "ff", "vocab", "experts", "lru")}
    fsdp = needs_fsdp(arch_name)
    return {
        "embed": ("data",) if fsdp else None,
        "heads": "model",
        "kv": "model",
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "lru": "model",
    }


def batch_axes(multi_pod: bool, layout: str = "tp") -> Tuple[str, ...]:
    if layout == "dp":
        return ("pod", "data", "model") if multi_pod else ("data", "model")
    return ("pod", "data") if multi_pod else ("data",)
