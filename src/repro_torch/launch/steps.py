"""Step-function builders for the LLM cohort: the per-node training loss.

The port of ``node_loss_fn`` from ``repro/launch/steps.py``. The rest of
that module waits: the prefill and serve steps with the pipeline-parallel
decoders that drive them (ROADMAP slice G2), the sharded train step the
dry-run lowers with the production dry-run (slice H).
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
    ``lm_loss + aux_coef * moe_aux`` of one node's (unstacked) params. An
    enc-dec model also reads ``batch["frames"]`` (B, T, d), which it
    encodes into the decoder's memory; a batch with ``prefix_embeds`` (B, P,
    d) puts them ahead of the tokens (the labels then cover P + S)."""

    def loss(params: PyTree, batch: dict) -> torch.Tensor:
        kw = {}
        if cfg.enc_dec:
            kw["memory"] = TF.encode(params, cfg, batch["frames"])
        if "prefix_embeds" in batch:
            kw["prefix_embeds"] = batch["prefix_embeds"]
        logits, aux = TF.forward(params, cfg, batch["tokens"], remat=remat, **kw)
        return lm_loss(logits, batch["labels"]) + aux_coef * aux

    return loss
