"""Nested parameter trees: dicts (keys in sorted order, as ``jax.tree``
walks them), lists and tuples, with tensors or arrays at the leaves."""
from __future__ import annotations

__all__ = ["tree_map", "tree_leaves", "flatten_with_path", "unflatten_like"]

SEP = "||"  # joins path components into a checkpoint key


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); returns a tree of the results."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def flatten_with_path(tree, prefix=()) -> list:
    """``[(key, leaf), ...]`` in ``tree_map`` order; ``key`` joins the dict
    keys and sequence indices on the way down with ``||`` (the reference
    checkpoint's key form)."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), t) for i, t in enumerate(tree))
    else:
        return [(SEP.join(prefix), tree)]
    return [kv for name, sub in items
            for kv in flatten_with_path(sub, prefix + (name,))]


def unflatten_like(template, leaves):
    """A tree of ``template``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)
