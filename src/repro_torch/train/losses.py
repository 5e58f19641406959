"""Loss functions (f32 accumulation regardless of activation dtype)."""

from __future__ import annotations

import torch

__all__ = ["lm_loss", "softmax_xent"]


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the batch axis. logits (..., B, C), labels
    (..., B) int -> (...): leading axes such as the node axis are kept, as
    the reference's ``softmax_xent`` under ``vmap`` keeps them."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return (logz - gold).mean(dim=-1)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, *, ignore: int = -1) -> torch.Tensor:
    """Next-token cross-entropy with an ignore index, in f32; logits (B, S,
    V), labels (B, S). The mean over the labels that are not ``ignore``."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    safe = torch.clamp(labels.long(), min=0)
    gold = logits.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    mask = (labels != ignore).float()
    return torch.sum((logz - gold) * mask) / torch.clamp(mask.sum(), min=1.0)
