"""The pytree walks the training modules need, over the port's trees:
nested dicts (keys sorted, as jax.tree flattens them), tuples and lists
(by index) and NamedTuples (by field), with tensors and arrays as leaves.
The key path of a leaf is the reference's checkpoint key
(repro/train/checkpoint.py::_leaf_paths): a dict key as it is, an index
as its number, a NamedTuple field as ".name", joined by "/"."""

from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """[(key path, leaf)] in jax.tree's order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_paths(tree[k], prefix + (str(k),))
        return out
    if _is_namedtuple(tree):
        out = []
        for f in tree._fields:
            out += leaves_with_paths(getattr(tree, f), prefix + (f".{f}",))
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, v in enumerate(tree):
            out += leaves_with_paths(v, prefix + (str(i),))
        return out
    return [("/".join(prefix), tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_unflatten(like, leaves) -> Any:
    """A tree of `like`'s structure holding `leaves` in tree_leaves'
    order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*(build(getattr(t, f)) for f in t._fields))
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """fn over the leaves of `tree` and the matching leaves of `rest`
    (trees of the same structure)."""
    cols = [tree_leaves(tree)] + [tree_leaves(r) for r in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees of different structure")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*cols)])
