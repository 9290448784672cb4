"""Nested containers of tensors, walked in the order ``jax.tree``
walks them: dict values by sorted key, tuples (``NamedTuple`` fields
included) and lists in order; ``None`` holds no leaf.  The optimizer,
the train step and checkpoints use it, so leaf ``i`` here is leaf ``i``
of the reference's ``jax.tree.leaves``."""
from __future__ import annotations

from typing import Any, Callable, List


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in the reference's order."""
    out: List[Any] = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (tuple, list)):
            for v in t:
                walk(v)
        elif t is not None:
            out.append(t)
    walk(tree)
    return out


def unflatten(template, values):
    """``template``'s structure with its leaves replaced, in order, by
    ``values`` (which must hold exactly as many)."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)
    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more values than the template has leaves")
    return out


def tree_map(fn: Callable, tree, *rest):
    """fn(leaf, *matching leaves of ``rest``) over ``tree``'s structure."""
    cols = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees of different leaf counts")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])
