"""The port's parameter trees: a tensor, or a dict of trees.

The reference threads JAX pytrees through its consensus runtime; the port
uses dicts of tensors, e.g. {"theta": (N, D)}. Leaves come in sorted-key
order, the order `jax.tree.leaves` gives for a dict.
"""
from __future__ import annotations

import torch


def tree_leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """fn applied leafwise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_unflatten(like, leaves: list[torch.Tensor]):
    """A tree with the structure of `like` holding `leaves` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
