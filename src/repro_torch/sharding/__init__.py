"""Logical-axis sharding of the port (MaxText-style rules).

Port of ``repro/sharding/__init__.py``'s rule tables and of the
divisibility rule of its ``spec_for``, with ``FSDP_ARCHS`` /
``needs_fsdp`` (``repro/sharding/specs.py``; that module imports jax):
archs whose parameters cannot replicate across the data-parallel ranks
run the sharded flat engine, params and optimizer moments resident 1/N
per rank (DESIGN.md §8).

A rule table maps a *logical* dimension name ("heads", "ff", "vocab",
...) to a mesh axis, a tuple of mesh axes, or None (replicated).  A spec
is a :class:`PartitionSpec`: one such value per dimension of a tensor.
JAX's model code annotates activations with ``constrain`` under an
active table and lets XLA insert the collectives; the port has no such
context.  It places parameters by ``specs.spec_tree`` and runs the
collectives itself (``sharding/tp.py``), so only the tables and the
divisibility rule come over.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

AxisVal = Union[None, str, Tuple[str, ...]]

FSDP_ARCHS = frozenset(
    {"deepseek-v2-236b", "llama4-maverick-400b-a17b", "llama-3.2-vision-90b"}
)


def needs_fsdp(arch_name: str) -> bool:
    return arch_name.split("-smoke")[0] in FSDP_ARCHS


class PartitionSpec:
    """The mesh axes of each dimension of one tensor (JAX's
    ``PartitionSpec``): a sequence of :data:`AxisVal`, equal to the tuple
    of its entries.  Not a ``tuple`` subclass, so a tree of specs keeps
    them as leaves (``repro_torch.tree`` walks tuples)."""

    __slots__ = ("axes",)

    def __init__(self, *axes: AxisVal):
        self.axes = tuple(axes)

    def __iter__(self):
        return iter(self.axes)

    def __len__(self) -> int:
        return len(self.axes)

    def __getitem__(self, i):
        return self.axes[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self.axes == other.axes
        return isinstance(other, tuple) and self.axes == other

    def __hash__(self) -> int:
        return hash(self.axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.axes!r}"


def axis_names(axis: AxisVal) -> Tuple[str, ...]:
    """The mesh axes one spec entry names, in order."""
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(mesh_shape: Mapping[str, int], axis: AxisVal) -> int:
    """The product of the sizes of the mesh axes ``axis`` names (an axis
    absent from the mesh counts 1, as JAX's ``_axis_prod``)."""
    return int(math.prod(mesh_shape.get(n, 1) for n in axis_names(axis)))


def spec_for(names: Sequence[Optional[str]], rules: Dict[str, AxisVal],
             mesh_shape: Mapping[str, int], shape=None) -> PartitionSpec:
    """The spec of a tensor whose dims carry the logical ``names`` under
    ``rules`` on a mesh of ``mesh_shape`` ({axis: size}).  An axis whose
    dimension does not divide its mesh size is dropped (replicated):
    36 heads over a 16-way 'model' axis stay whole."""
    out = []
    for i, n in enumerate(names):
        axis = rules.get(n) if n else None
        if axis is not None and shape is not None \
                and shape[i] % axis_size(mesh_shape, axis) != 0:
            axis = None
        out.append(axis)
    return PartitionSpec(*out)


# ---------------------------------------------------------------------------
# Canonical rule tables
# ---------------------------------------------------------------------------
def rules_pjit(multi_pod: bool, fsdp: bool, layout: str = "tp"
               ) -> Dict[str, AxisVal]:
    """Baseline pjit train/serve step (XLA inserts every collective)."""
    if layout == "dp":
        batch = ("pod", "data", "model") if multi_pod else ("data", "model")
        return {"batch": batch, "embed": None, "heads": None, "kv": None,
                "ff": None, "vocab": None, "experts": None, "lru": None,
                "seq": None, "modal": None}
    batch = ("pod", "data") if multi_pod else ("data",)
    del fsdp  # FSDP shards *weights* (see specs.param_rules); activations
    #           keep 'embed' replicated to avoid batch/data double-mapping.
    return {
        "batch": batch,
        "embed": None,
        "heads": "model",
        "kv": "model",
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "lru": "model",
        "seq": None,
        "modal": None,
    }


def rules_deft_manual_dp() -> Dict[str, AxisVal]:
    """Inside shard_map manual over ('pod','data'): batch dims are local."""
    return {
        "batch": None,
        "embed": None,
        "heads": "model",
        "kv": "model",
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "lru": "model",
        "seq": None,
        "modal": None,
    }


def rules_deft_rs_manual_pod() -> Dict[str, AxisVal]:
    """Inside shard_map manual over ('pod',): data axis still auto (FSDP +
    batch sharding handled by XLA); pod-axis collectives are explicit."""
    return {
        "batch": ("data",),
        "embed": None,   # weight FSDP comes from specs.param_rules, not here
        "heads": "model",
        "kv": "model",
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "lru": "model",
        "seq": None,
        "modal": None,
    }
