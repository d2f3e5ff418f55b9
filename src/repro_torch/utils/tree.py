"""Helpers over nested dict / list / tuple trees of tensors.

The port's parameter, optimizer-state and checkpoint trees are plain
containers with the same keys and nesting as the JAX package's pytrees.
Traversal order is the container's own (dict insertion order, sequence
order), identical for every helper here, so leaves listed by
:func:`tree_leaves` line up with the calls :func:`tree_map` makes.
"""

from __future__ import annotations

from typing import Any, Callable, List

__all__ = ["tree_map", "tree_leaves"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over structurally identical trees.  ``None``
    is a subtree without leaves and maps to ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *[r[i] for r in rest])
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in :func:`tree_map`'s traversal order."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out
