"""Trees of tensors as the optimizer walks them: nested dicts (keys in
sorted order, the reference's ``jax.tree`` order) and lists, each leaf
named by its path joined with ``.``."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in the reference's flattening order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves(tree[k], f"{prefix}{k}.")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += leaves(v, f"{prefix}{i}.")
        return out
    return [(prefix[:-1], tree)]


def tree_map(fn: Callable, tree: Any) -> Any:
    """``tree`` with ``fn`` applied to each leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)
