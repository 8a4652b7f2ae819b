"""Trees of tensors: nested dicts, lists and tuples (named tuples too)
with tensor leaves, as the port's parameter and optimiser-state trees
are. ``None`` is an empty subtree, as in ``jax.tree``; dict keys are
visited in sorted order, so two dicts with the same keys flatten alike
whatever order they were built in.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for t in tree for l in tree_leaves(t)]
    return [tree]


def tree_unflatten(template, leaves) -> Any:
    """A tree shaped like ``template`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)
    out = _rebuild(template, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _rebuild(t, it):
    if t is None:
        return None
    if isinstance(t, dict):
        vals = {k: _rebuild(t[k], it) for k in sorted(t)}
        return {k: vals[k] for k in t}
    if isinstance(t, (list, tuple)):
        vals = [_rebuild(v, it) for v in t]
        if isinstance(t, list):
            return vals
        return type(t)(*vals) if hasattr(t, "_fields") else tuple(vals)
    try:
        return next(it)
    except StopIteration:
        raise ValueError("fewer leaves than the template holds") from None


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` applied leaf by leaf over ``tree`` and trees of its shape."""
    flat = [tree_leaves(t) for t in (tree,) + rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different structure")
    return tree_unflatten(tree, [fn(*ls) for ls in zip(*flat)])
