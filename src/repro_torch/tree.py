"""Nested dict/tuple parameter trees in ``jax.tree_util`` leaf order.

The port keeps the JAX package's parameter tree (nested dicts and tuples
of arrays) and its leaf order, because ``BucketLayout`` offsets are
defined over that order: dict children in sorted key order, tuple and
list children by position.  Any other mapping or sequence (the lazy views
of ``train/streaming.py``) is walked the same way and rebuilt as a dict
or tuple.  Anything else is a leaf.
"""
from __future__ import annotations

from collections.abc import Mapping
from collections.abc import Sequence as SequenceABC
from typing import Any, Callable, Iterator, List, Sequence, Tuple

Path = Tuple[str, ...]


def _children(node) -> Iterator[Tuple[str, Any]]:
    if isinstance(node, Mapping):
        for k in sorted(node):
            yield str(k), node[k]
    else:
        for i, c in enumerate(node):
            yield str(i), c


def _is_node(x) -> bool:
    return isinstance(x, (Mapping, SequenceABC)) and not isinstance(
        x, (str, bytes))


def tree_flatten_with_path(tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """[(path, leaf)] in tree_flatten order; a path is the tuple of dict
    keys and sequence indices (as strings) leading to the leaf."""
    if not _is_node(tree):
        return [(prefix, tree)]
    out: List[Tuple[Path, Any]] = []
    for key, child in _children(tree):
        out.extend(tree_flatten_with_path(child, prefix + (key,)))
    return out


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_unflatten(structure, leaves: Sequence[Any]):
    """A tree shaped like ``structure`` holding ``leaves`` in order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, Mapping):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (tuple, list)):
            return type(node)(build(c) for c in node)
        if _is_node(node):
            return tuple(build(c) for c in node)
        return next(it)

    out = build(structure)
    end = object()
    if next(it, end) is not end:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_dense(tree):
    """A plain dict/tuple tree of ``tree``'s leaves: materializes a lazy
    view, and copies only the containers of a plain tree."""
    return tree_unflatten(tree, tree_leaves(tree))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leafwise over ``tree`` (and same-shaped ``rest``)."""
    others = [tree_leaves(r) for r in rest]
    leaves = tree_leaves(tree)
    return tree_unflatten(
        tree, [fn(x, *(o[i] for o in others)) for i, x in enumerate(leaves)]
    )
