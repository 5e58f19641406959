"""AdamW for the LLM-cohort trainer, over node-stacked parameter trees. The
port of ``repro/optim/adamw.py``: the same defaults (``b2=0.95``,
``weight_decay=0.1``) and the same expression order, so each value rounds
as the reference's does: the moments are computed in f32 and cast to the
moment dtype, ``c1 = 1 - b1 ** count``, and the parameter update is
``(p.float() * (1 - lr * wd) - step).to(p.dtype)``.

``update`` returns new trees, as the reference does. ``update_`` writes the
moments, the step count and the parameters in place, for the captured rounds
of ``run_fused`` (static buffers) and for members too large to hold a second
copy of: it runs the same operations in the same order, so both forms give
the same bits. ``lr`` may be a float or an f32 0-dim tensor on the
parameters' device (a captured graph's learning rate, computed on the device
from the round).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["AdamWState", "init", "update", "update_"]

PyTree = Any


class AdamWState(NamedTuple):
    mu: PyTree
    nu: PyTree
    count: torch.Tensor  # () int32, shared by every node


def init(params: PyTree, *, dtype: torch.dtype = torch.float32) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=dtype, device=p.device)

    dev = tree_leaves(params)[0].device
    return AdamWState(tree_map(zeros, params), tree_map(zeros, params),
                      torch.zeros((), dtype=torch.int32, device=dev))


def _corrections(count: torch.Tensor, b1: float, b2: float):
    c = count.to(torch.float32)
    return 1.0 - b1 ** c, 1.0 - b2 ** c


def _lr(lr, device) -> torch.Tensor:
    if isinstance(lr, torch.Tensor):
        return lr.to(torch.float32)
    return torch.tensor(lr, dtype=torch.float32, device=device)


def _mu(g: torch.Tensor, m: torch.Tensor, b1: float) -> torch.Tensor:
    return (b1 * m.float() + (1 - b1) * g.float()).to(m.dtype)


def _nu(g: torch.Tensor, v: torch.Tensor, b2: float) -> torch.Tensor:
    return (b2 * v.float() + (1 - b2) * torch.square(g.float())).to(v.dtype)


def _step(m, v, lr, c1, c2, eps):
    return lr * (m.float() / c1) / (torch.sqrt(v.float() / c2) + eps)


@torch.no_grad()
def update(
    grads: PyTree,
    state: AdamWState,
    params: PyTree,
    *,
    lr: float | torch.Tensor,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> tuple[PyTree, AdamWState]:
    count = state.count + 1
    c1, c2 = _corrections(count, b1, b2)
    lr = _lr(lr, count.device)
    new_mu = tree_map(lambda g, m: _mu(g, m, b1), grads, state.mu)
    new_nu = tree_map(lambda g, v: _nu(g, v, b2), grads, state.nu)

    def new_p(p, m, v):
        step = _step(m, v, lr, c1, c2, eps)
        return (p.float() * (1.0 - lr * weight_decay) - step).to(p.dtype)

    return tree_map(new_p, params, new_mu, new_nu), AdamWState(new_mu, new_nu, count)


@torch.no_grad()
def update_(
    grads: PyTree,
    state: AdamWState,
    params: PyTree,
    *,
    lr: float | torch.Tensor,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> None:
    """``update`` in place on ``state`` and ``params``, leaf by leaf (the
    transients are one leaf's, never the tree's)."""
    state.count.add_(1)
    c1, c2 = _corrections(state.count, b1, b2)
    lr = _lr(lr, state.count.device)
    decay = 1.0 - lr * weight_decay
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu),
                          tree_leaves(params)):
        m.copy_(_mu(g, m, b1))
        v.copy_(_nu(g, v, b2))
        p.copy_((p.float() * decay - _step(m, v, lr, c1, c2, eps)).to(p.dtype))
