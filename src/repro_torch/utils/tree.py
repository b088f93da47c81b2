"""Nested-dict parameter trees, flattened in the JAX package's leaf order.

``jax.tree.flatten`` visits dict keys in sorted order, and the sync plan's
leaf slots (and with them the contents of every fusion bucket) follow that
order. These helpers flatten the port's dict trees the same way. Only
dicts are containers; anything else (a tensor, a spec tuple, None) is a
leaf.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_flatten(tree) -> tuple[list, list[tuple[str, ...]]]:
    """(leaves, paths) in sorted-key depth-first order."""
    leaves, paths = [], []
    _walk(tree, (), leaves, paths)
    return leaves, paths


def _walk(node, path: tuple, leaves: list, paths: list) -> None:
    # a module-level function, not a closure that calls itself: such a
    # closure is a reference cycle that would hold ``leaves`` (a step's
    # gradients, say) until Python's collector runs
    if isinstance(node, dict):
        for key in sorted(node):
            _walk(node[key], path + (key,), leaves, paths)
    else:
        leaves.append(node)
        paths.append(path)


def tree_unflatten(paths: list[tuple[str, ...]], leaves: list) -> dict:
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn: Callable[..., Any], tree, *rest):
    """Apply fn leafwise over trees of the same structure."""
    leaves, paths = tree_flatten(tree)
    others = [tree_flatten(t)[0] for t in rest]
    return tree_unflatten(paths, [fn(*xs) for xs in zip(leaves, *others)])


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]
