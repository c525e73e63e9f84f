"""Helpers over parameter trees: nested dicts (and lists) of tensors.

The order of the leaves is JAX's (dict keys sorted at every level, a list
in its order), so the
port walks ``conv1.b, conv1.w, conv2.b, ..., fc3.w`` exactly as the
reference does. The wire payload, its bytes and the per-leaf metadata all
follow that order.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np

Tree = Dict[str, Any]


def tree_leaves_with_path(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(dotted_path, leaf), ...]`` in sorted-key order."""
    out = []
    keys = range(len(tree)) if isinstance(tree, list) else sorted(tree)
    for key in keys:
        path = f"{prefix}.{key}" if prefix else str(key)
        val = tree[key]
        if isinstance(val, (dict, list)):
            out.extend(tree_leaves_with_path(val, path))
        else:
            out.append((path, val))
    return out


def tree_leaves(tree: Tree) -> List[Any]:
    return [x for _, x in tree_leaves_with_path(tree)]


def tree_unflatten(paths: List[str], leaves: List[Any]) -> Tree:
    """Inverse of :func:`tree_leaves_with_path`: a node whose keys are the
    indices ``0 .. n-1`` is a list again (a decoder's unscanned
    ``layers``)."""
    out: Tree = {}
    for path, leaf in zip(paths, leaves):
        node = out
        *parents, last = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf

    def relist(node):
        if not isinstance(node, dict):
            return node
        node = {k: relist(v) for k, v in node.items()}
        if node and sorted(node) == sorted(str(i) for i in range(len(node))):
            return [node[str(i)] for i in range(len(node))]
        return node
    return relist(out)


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leafwise over trees of the same structure."""
    def node(v, *rs):
        return (tree_map(fn, v, *rs) if isinstance(v, (dict, list))
                else fn(v, *rs))
    if isinstance(tree, list):
        return [node(v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return {k: node(v, *(r[k] for r in rest)) for k, v in tree.items()}


def tree_map_with_path(fn: Callable, tree: Tree, prefix: str = "") -> Tree:
    """``fn(dotted_path, leaf)`` leafwise, keeping the tree's structure."""
    def node(key, v):
        path = f"{prefix}.{key}" if prefix else str(key)
        return (tree_map_with_path(fn, v, path)
                if isinstance(v, (dict, list)) else fn(path, v))
    if isinstance(tree, list):
        return [node(i, v) for i, v in enumerate(tree)]
    return {k: node(k, v) for k, v in tree.items()}


def tree_count(tree: Tree) -> int:
    """Total number of elements across leaves."""
    return int(sum(int(np.prod(tuple(x.shape))) for x in tree_leaves(tree)))


def tree_layout(tree: Tree) -> List[Tuple[str, tuple, Any]]:
    """``[(path, shape, dtype), ...]``: what a buffer must match to take the
    tree's values by ``copy_``."""
    return [(p, tuple(x.shape), x.dtype)
            for p, x in tree_leaves_with_path(tree)]
