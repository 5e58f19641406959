"""Gossip compression: top-k delta sparsification with reference tracking.

Each node transmits only the k largest-magnitude entries of ``params -
reference``, where ``reference`` is the model its peers currently hold.
Error feedback is implicit in the reference: whatever was not transmitted
stays in ``params - reference`` and competes again next round.

The reference package vmaps these functions over the node axis; here they
take node-stacked trees directly, and the top-k is taken per node and per
leaf: ``k = max(1, int(k_frac * size))`` with ``size`` one node's share of
the leaf (``leaf.numel() // N``), not the stacked leaf's. ``torch.topk`` and
``jax.lax.top_k`` may order equal magnitudes differently, so the two
packages' masks can differ only among ties of equal non-zero magnitude (a
tie among zero deltas sends zero either way).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["CompressState", "init", "compress", "reconstruct", "wire_bytes"]

PyTree = Any


class CompressState(NamedTuple):
    reference: PyTree  # what peers currently hold for each node


def init(params: PyTree) -> CompressState:
    """The reference starts at the params: genuine f32 copies, never views
    of the params (the trainer updates both in place)."""
    return CompressState(
        reference=tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
    )


def _topk_mask(x: torch.Tensor, k_frac: float) -> torch.Tensor:
    """Exact per-node top-k mask of a node-stacked leaf (an index scatter: a
    >= threshold test would over-select whenever magnitudes tie)."""
    flat = x.reshape(x.shape[0], -1)
    k = max(1, int(k_frac * flat.shape[1]))
    _, idx = torch.topk(flat.abs(), k, dim=1, sorted=False)
    mask = torch.zeros_like(flat).scatter_(1, idx, 1.0)
    return mask.reshape(x.shape)


def compress(
    params: PyTree, state: CompressState, *, k_frac: float = 0.05
) -> tuple[PyTree, CompressState]:
    """Returns (sparse_delta, new_state) for every node at once.

    ``sparse_delta`` has ``max(1, int(k_frac * size))`` nonzeros per node and
    leaf; the reference advances by what was sent, so the residual re-enters
    the next round's selection.
    """

    def sent(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        delta = p.float() - r
        return delta * _topk_mask(delta, k_frac)

    delta = tree_map(sent, params, state.reference)
    ref = tree_map(lambda r, s: r + s, state.reference, delta)
    return delta, CompressState(ref)


def reconstruct(state: CompressState) -> PyTree:
    """The model every peer currently holds for each node."""
    return state.reference


def wire_bytes(params: PyTree, *, k_frac: float) -> int:
    """Per-round payload of one node's params: k values (f32) + k indices
    (int32) per leaf."""
    return sum(max(1, int(k_frac * leaf.numel())) * 8 for leaf in tree_leaves(params))
