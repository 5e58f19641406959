"""SGD with momentum (the paper's optimizer) over node-stacked parameter
trees: ``m = mu * m + g``, then ``p = p - lr * m`` in the momentum dtype.

``init`` and ``update`` are the reference's pure functions over an
``SGDState`` (``launch.steps.build_train_step`` uses them). The trainers use
``update_``, which writes momentum and parameters in place: at paper size
each is 227 MB of node-stacked f32, and copying them every local step buys
nothing.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

__all__ = ["SGDState", "init", "update", "update_"]


class SGDState(NamedTuple):
    momentum: PyTree


def init(params: PyTree, *, dtype: torch.dtype | None = None) -> SGDState:
    """Zero momentum shaped like ``params``, in ``dtype`` (default f32)."""
    return SGDState(tree_map(
        lambda p: torch.zeros(p.shape, dtype=dtype or torch.float32, device=p.device), params))


@torch.no_grad()
def update(
    grads: PyTree,
    state: SGDState,
    params: PyTree,
    *,
    lr: float | torch.Tensor,
    mu: float = 0.5,
    weight_decay: float = 0.0,
) -> tuple[PyTree, SGDState]:
    """One step as new trees: ``m = mu * m + g (+ wd * p)``, then
    ``p - lr * m`` in the momentum dtype, stored in the params' dtype (the
    reference's expression order)."""

    def new_m(g, m, p):
        gf = g.to(m.dtype)
        if weight_decay:
            gf = gf + weight_decay * p.to(m.dtype)
        return mu * m + gf

    new_mom = tree_map(new_m, grads, state.momentum, params)

    def step(p, m):
        lr_t = torch.as_tensor(lr, dtype=m.dtype, device=m.device)
        return (p.to(m.dtype) - lr_t * m).to(p.dtype)

    return tree_map(step, params, new_mom), SGDState(new_mom)


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
