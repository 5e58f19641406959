"""SGD with momentum (the paper's optimizer) over node-stacked parameter
trees: ``m = mu * m + g``, then ``p = p - lr * m`` in the momentum dtype.

Unlike the reference's pure functions, ``update_`` writes momentum and
parameters in place: at paper size each is 227 MB of node-stacked f32, and
copying them every local step buys nothing.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

__all__ = ["init", "update_"]


def init(params: PyTree) -> PyTree:
    """Zero f32 momentum, shaped like ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


@torch.no_grad()
def update_(grads: PyTree, momentum: PyTree, params: PyTree, *, lr: float | torch.Tensor,
            mu: float) -> None:
    """One step, in place on ``momentum`` and ``params``: the reference's
    ``p - lr * m`` in the momentum dtype, stored in the params' dtype. ``lr``
    may be an f32 0-dim tensor on the device (a schedule's rate in a captured
    graph)."""
    for g, m, p in zip(tree_leaves(grads), tree_leaves(momentum), tree_leaves(params)):
        m.mul_(mu).add_(g.to(m.dtype))
        p.sub_(m * lr)
