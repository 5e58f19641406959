"""Evaluation metrics: per-node accuracy, class-group ("knowledge spread")
accuracy, confusion matrices and consensus distance.

Each takes logits with leading axes (the node axis) and reduces over the
batch axis only, as the reference's functions do under ``vmap``, so a run
whose nodes are sharded over devices computes them a slab at a time and
gathers the (N,) results; consensus needs the node mean first
(``sharded_consensus_distance``).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import mesh as mesh_mod
from repro_torch.tree import tree_leaves

PyTree = Any

__all__ = [
    "accuracy", "group_accuracy", "consensus_distance", "sharded_consensus_distance",
    "confusion_matrix", "community_confusion",
]


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (..., B, C), labels (B,) -> (...) fraction correct."""
    return (logits.argmax(dim=-1) == labels).float().mean(dim=-1)


def group_accuracy(
    logits: torch.Tensor, labels: torch.Tensor, class_groups: torch.Tensor, num_groups: int
) -> torch.Tensor:
    """(..., G) accuracy restricted to each class group.

    ``class_groups`` maps class id -> group id. Groups with no test examples
    report 0.
    """
    correct = (logits.argmax(dim=-1) == labels).float()  # (..., B)
    onehot = torch.nn.functional.one_hot(class_groups[labels].long(), num_groups).float()
    num = correct @ onehot  # exact: sums of 0/1 in f32
    den = onehot.sum(dim=0)
    return num / den.clamp(min=1.0)


def consensus_distance(params: PyTree) -> torch.Tensor:
    """(N,) per-node L2 distance to the node-mean model, ||theta_i - theta_bar||.

    An empty tree has no node axis to read N from, so it yields shape (0,).
    The one-shard case of ``sharded_consensus_distance``, to the bit.
    """
    leaves = tree_leaves(params)
    if not leaves:
        return torch.zeros((0,), dtype=torch.float32)
    return sharded_consensus_distance([params], leaves[0].device)


def sharded_consensus_distance(slabs: list[PyTree], device: torch.device, *,
                               in_node_order: bool = False) -> torch.Tensor:
    """``consensus_distance`` of a node axis held as per-shard slabs (shard
    s's (blk, ...) tree on its own device, in node order): each leaf's node
    mean is the shards' column sums added in shard order (``core.mesh.psum``)
    over N, each shard then measures its own nodes, and only the (N,)
    distances are gathered, to ``device``. ``in_node_order`` adds the nodes
    one at a time in node order instead (``core.mesh.psum_rows``), N adds a
    leaf, so any shard count gives the same bits."""
    per_shard = [tree_leaves(t) for t in slabs]
    devices = [leaves[0].device for leaves in per_shard]
    n = sum(int(leaves[0].shape[0]) for leaves in per_shard)
    totals: list[torch.Tensor | None] = [None] * len(slabs)
    for j in range(len(per_shard[0])):
        flats = [leaves[j].reshape(leaves[j].shape[0], -1).float() for leaves in per_shard]
        sums = (mesh_mod.psum_rows(flats, devices) if in_node_order
                else mesh_mod.psum([f.sum(dim=0, keepdim=True) for f in flats], devices))
        for s, (f, total) in enumerate(zip(flats, sums)):
            sq = ((f - total / n) ** 2).sum(dim=1)
            totals[s] = sq if totals[s] is None else totals[s] + sq
    return mesh_mod.gather([t.sqrt() for t in totals], device)


def confusion_matrix(logits: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(..., C, C) row-normalized confusion matrix: row = true class, col =
    prediction. Rows with no examples are zero."""
    preds = logits.argmax(dim=-1)  # (..., B)
    lead = preds.shape[:-1]
    idx = (labels * num_classes + preds).reshape(-1, preds.shape[-1])
    counts = torch.zeros(idx.shape[0], num_classes * num_classes, device=logits.device)
    counts.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.float32))
    cm = counts.reshape(*lead, num_classes, num_classes)
    return cm / cm.sum(dim=-1, keepdim=True).clamp(min=1.0)


def community_confusion(
    per_node_cm: torch.Tensor, blocks: torch.Tensor, num_comms: int
) -> torch.Tensor:
    """Average per-node confusion matrices within each community (paper
    Table 1). per_node_cm: (N, C, C); blocks: (N,) int -> (num_comms, C, C)."""
    mask = torch.nn.functional.one_hot(blocks.long(), num_comms).float().T  # (K, N)
    w = mask / mask.sum(dim=1, keepdim=True).clamp(min=1.0)
    return torch.einsum("kn,nij->kij", w, per_node_cm.float())
