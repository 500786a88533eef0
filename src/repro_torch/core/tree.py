"""Nested dicts of tensors — the port's parameter and state trees.

The reference keeps parameters, gradients and optimizer moments as JAX
pytrees of nested dicts; the port keeps the same nesting with tensors at
the leaves and addresses a leaf by its "/"-joined key path.
"""
from __future__ import annotations


def tree_leaves(tree, prefix: str = "") -> list:
    """[(path, leaf)] of a nested dict, keys in sorted order (the
    reference's flattening order)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` (and of same-shaped `rest` trees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


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
