"""The few tree operations the training modules need, on the port's
parameter trees: dicts (keys in sorted order, as ``jax.tree`` flattens
them), lists and tuples, dataclasses (fields in order) and tensors at the
leaves.  ``None`` is an empty subtree, as in JAX."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple


def _children(tree) -> List[Tuple[str, Any]]:
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    raise TypeError(f"not a tree node: {type(tree)}")


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple)) or (
        dataclasses.is_dataclass(tree) and not isinstance(tree, type))


def leaves_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of every leaf, paths joined by '/'."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for name, child in _children(tree):
        out += leaves_with_paths(child, f"{prefix}/{name}" if prefix
                                 else name)
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(tree, values: List[Any]):
    """``tree``'s structure with its leaves replaced, in order, by
    ``values``."""
    it = iter(values)

    def build(node):
        if node is None:
            return None
        if not _is_node(node):
            return next(it)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return dataclasses.replace(node, **{
            f.name: build(getattr(node, f.name))
            for f in dataclasses.fields(node)})

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    columns = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(c) != len(columns[0]) for c in columns):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*columns)])
