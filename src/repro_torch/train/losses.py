"""Loss functions (f32 accumulation regardless of activation dtype)."""

from __future__ import annotations

import torch

__all__ = ["softmax_xent"]


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the batch axis. logits (..., B, C), labels
    (..., B) int -> (...): leading axes such as the node axis are kept, as
    the reference's ``softmax_xent`` under ``vmap`` keeps them."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return (logz - gold).mean(dim=-1)
