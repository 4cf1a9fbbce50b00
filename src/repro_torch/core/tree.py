"""Trees of tensors, walked in the JAX package's pytree order.

A tree is nested dicts, lists, tuples and named tuples of leaves;
``None`` is an empty subtree. Dict keys are walked sorted and named
tuple fields in their order, as ``jax.tree_util`` walks them, and a
leaf's path string is the one the JAX package's checkpointer writes:
each dict key and list index as it prints, each named-tuple field as
``.name``, joined with ``/`` (``.opt/.mu/stages/0/stacked/0/attn/wqkv``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _children(t):
    """(path part, child) of a node, in the JAX walk order."""
    if isinstance(t, dict):
        return [(str(k), t[k]) for k in sorted(t)]
    if _is_namedtuple(t):
        return [("." + f, getattr(t, f)) for f in t._fields]
    return [(str(i), c) for i, c in enumerate(t)]


def _is_node(t) -> bool:
    return isinstance(t, (dict, list, tuple))


def leaves_with_paths(tree) -> List[Tuple[str, Any]]:
    """(path, leaf) of every leaf of ``tree``, in the JAX walk order."""
    out = []

    def walk(t, prefix):
        if t is None:
            return
        if not _is_node(t):
            out.append(("/".join(prefix), t))
            return
        for part, child in _children(t):
            walk(child, prefix + [part])
    walk(tree, [])
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like, new_leaves):
    """A tree of ``like``'s structure holding ``new_leaves`` in the walk
    order."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if not _is_node(t):
            return next(it)
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        items = [build(c) for c in t]
        return type(t)(*items) if _is_namedtuple(t) else type(t)(items)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of trees of one structure."""
    flat = [leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different structures")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
