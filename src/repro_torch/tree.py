"""Plain helpers over parameter trees: nested dicts and lists of tensors, in
the reference's ``jax.tree`` leaf order (dict keys sorted, lists in order)."""

from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["tree_map", "tree_map_with_path", "tree_leaves", "tree_unflatten"]


def tree_map(fn: Callable[..., torch.Tensor], tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over ``tree`` and the same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable[..., Any], tree: Any, *rest: Any,
                       _path: tuple = ()) -> Any:
    """``fn(path, leaf, *rest_leaves)`` leaf-wise, ``path`` the tuple of dict
    keys and list indices from the root (the reference's key path). ``None``
    is an empty subtree, as in ``jax.tree``, and stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest), _path=_path + (k,))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, t, *(r[i] for r in rest), _path=_path + (i,))
                for i, t in enumerate(tree)]
    return fn(_path, tree, *rest)


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The leaves of ``tree`` in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten(tree: Any, leaves: list[torch.Tensor]) -> Any:
    """``tree``'s structure with ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
