"""Helpers over parameter trees: nested dicts of tensors.

The order of the leaves is JAX's (dict keys sorted at every level), so the
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
    for key in sorted(tree):
        path = f"{prefix}.{key}" if prefix else key
        val = tree[key]
        if isinstance(val, dict):
            out.extend(tree_leaves_with_path(val, path))
        else:
            out.append((path, val))
    return out


def tree_leaves(tree: Tree) -> List[Any]:
    return [x for _, x in tree_leaves_with_path(tree)]


def tree_unflatten(paths: List[str], leaves: List[Any]) -> Tree:
    """Inverse of :func:`tree_leaves_with_path`."""
    out: Tree = {}
    for path, leaf in zip(paths, leaves):
        node = out
        *parents, last = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leafwise over trees of the same structure."""
    return {k: (tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
                else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


def tree_count(tree: Tree) -> int:
    """Total number of elements across leaves."""
    return int(sum(int(np.prod(tuple(x.shape))) for x in tree_leaves(tree)))


def tree_layout(tree: Tree) -> List[Tuple[str, tuple, Any]]:
    """``[(path, shape, dtype), ...]``: what a buffer must match to take the
    tree's values by ``copy_``."""
    return [(p, tuple(x.shape), x.dtype)
            for p, x in tree_leaves_with_path(tree)]
