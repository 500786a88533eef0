"""Nested dicts and lists of tensors — the port's parameter and state
trees.

The reference keeps parameters, gradients and optimizer moments as JAX
pytrees of nested dicts (and, for the paper's CNN and MLP, lists of
layer dicts); the port keeps the same nesting with tensors at the
leaves and addresses a leaf by its "/"-joined key path (a list item by
its index).  Leaves come in JAX's flattening order: dict keys sorted,
list items in index order.
"""
from __future__ import annotations


def _children(tree):
    """[(key, child)] of a dict (keys sorted) or a list (in order), or
    None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, list):
        return list(enumerate(tree))
    return None


def tree_leaves(tree, prefix: str = "") -> list:
    """[(path, leaf)] of a nested dict / list, in the reference's
    flattening order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix[:-1], tree)]
    return [kv for k, v in kids for kv in tree_leaves(v, f"{prefix}{k}/")]


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` (and of same-shaped `rest` trees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_unflatten(tree, leaves) -> object:
    """A tree shaped as `tree` holding `leaves` (in tree_leaves order)."""
    it = iter(leaves)

    def build(t):
        kids = _children(t)
        if kids is None:
            return next(it)
        if isinstance(t, dict):
            return {k: build(v) for k, v in kids}
        return [build(v) for _, v in kids]

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


def tree_get(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def tree_set(tree: dict, path: str, value) -> None:
    """Set the leaf at `path`, making the dicts on the way."""
    *head, last = path.split("/")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value
