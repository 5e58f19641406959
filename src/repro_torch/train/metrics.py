"""Evaluation metrics: per-node accuracy, class-group ("knowledge spread")
accuracy, confusion matrices and consensus distance.

Each takes logits with leading axes (the node axis) and reduces over the
batch axis only, as the reference's functions do under ``vmap``.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import tree_leaves

PyTree = Any

__all__ = [
    "accuracy", "group_accuracy", "consensus_distance", "confusion_matrix",
    "community_confusion",
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
    """
    total = None
    for leaf in tree_leaves(params):
        f = leaf.reshape(leaf.shape[0], -1).float()
        sq = ((f - f.mean(dim=0, keepdim=True)) ** 2).sum(dim=1)
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((0,), dtype=torch.float32)
    return total.sqrt()


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
