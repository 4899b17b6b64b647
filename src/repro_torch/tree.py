"""Nested dicts of tensors: the port's form of the JAX package's pytrees
(parameters, gradients, optimizer state)."""

from __future__ import annotations


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure (anything
    but a dict is a leaf)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """Leaves in the JAX package's order (``jax.tree.leaves``: dict keys
    sorted at every level)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_items(tree, prefix: str = "") -> list:
    """``(path, leaf)`` of every leaf, nested dicts walked in their own
    order, each path the keys down to the leaf joined by ``/`` (a flat
    dict's paths are its keys)."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [item for k, v in tree.items()
            for item in tree_items(v, f"{prefix}/{k}" if prefix else k)]
