"""Trees of tensors in the JAX package's flattening order.

A tree is nested dicts (keys in sorted order, as JAX flattens a dict),
NamedTuples (in field order) and lists or tuples; anything else is a
leaf. A leaf's name joins the keys on its path with "/", as
``repro.train.checkpoint`` names its leaves ("opt/m/embed").
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Tuple


def _children(tree) -> List[Tuple[str, Any]] | None:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def leaf_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) of every leaf, in flattening order."""
    children = _children(tree)
    if children is None:
        return [(prefix, tree)]
    out = []
    for key, value in children:
        out += leaf_paths(value, f"{prefix}/{key}" if prefix else key)
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaf_paths(tree)]


def unflatten(like, values: Iterable) -> Any:
    """A tree of ``like``'s structure (its dicts' key order too) holding
    ``values``, given in flattening order."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure)."""
    return unflatten(tree, map(fn, leaves(tree), *map(leaves, rest)))


__all__ = ["leaf_paths", "leaves", "tree_map", "unflatten"]
