"""Step-function builders for the LLM cohort: the per-node training loss.

The port of ``node_loss_fn`` from ``repro/launch/steps.py``. The rest of
that module (the sharded train, prefill and serve steps the dry-run lowers)
belongs to the production dry-run, ROADMAP slice H.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as TF
from repro_torch.train.losses import lm_loss

__all__ = ["node_loss_fn"]

PyTree = Any


def node_loss_fn(
    cfg: ArchConfig, *, aux_coef: float = 0.01, remat: bool = True
) -> Callable[[PyTree, dict], torch.Tensor]:
    """Per-node LM loss over one (B, S) batch dict ``{"tokens", "labels"}``:
    ``lm_loss + aux_coef * moe_aux`` of one node's (unstacked) params."""

    def loss(params: PyTree, batch: dict) -> torch.Tensor:
        if cfg.enc_dec or "prefix_embeds" in batch:
            raise NotImplementedError(
                "encoder-decoder and VLM losses are not ported yet (ROADMAP slice G)")
        logits, aux = TF.forward(params, cfg, batch["tokens"], remat=remat)
        return lm_loss(logits, batch["labels"]) + aux_coef * aux

    return loss
