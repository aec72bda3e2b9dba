"""Nested dicts / lists / tuples of tensors: the port's parameter trees.

The JAX package walks its pytrees with `jax.tree_util`; the port's trees
are plain containers, walked here in insertion order.  A leaf is anything
that is not a dict, list or tuple (tensors, and None where a tree holds
no value)."""

from __future__ import annotations

from typing import Callable, List


def tree_leaves(tree) -> list:
    """Every leaf of `tree`, depth first, in insertion order."""
    out: List = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            out.append(t)

    walk(tree)
    return out


def tree_map(fn: Callable, tree):
    """The same structure with `fn` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_unflatten(tree, leaves):
    """`tree`'s structure with its leaves replaced, in order, by `leaves`."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
