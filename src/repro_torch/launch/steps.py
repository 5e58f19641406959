"""Step-function builders: the per-node training loss, the decentralized
train step (local grad step + DecAvg gossip), the prefill step and the
serve (decode) step. The port of ``repro/launch/steps.py``.

Every step is a function of (params, opt_state, mixing matrix, batch) or
(params, token, cache) over node-stacked or plain trees of tensors on one
device. The reference's ``act_sharding`` (an activation sharding
constraint for its partitioner) is left out: one process holds the whole
tensors, and there is nothing to constrain.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import decavg
from repro_torch.models import transformer as TF
from repro_torch.optim import adamw, sgd
from repro_torch.train.losses import lm_loss
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["node_loss_fn", "build_train_step", "build_prefill_step", "build_serve_step"]

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


def build_train_step(
    cfg: ArchConfig,
    *,
    num_nodes: int,
    microbatches: int = 1,
    optimizer: str = "adamw",
    lr: float = 3e-4,
    aux_coef: float = 0.01,
    mix_fn: Callable | None = None,
    acc_dtype: torch.dtype = torch.float32,
) -> Callable:
    """One DecAvg communication round at LLM-cohort scale.

    Signature: (params, opt_state, w_mix, batch) -> (params, opt_state,
    loss), every param leaf node-stacked (N, ...) and every batch leaf laid
    out (microbatches, N, B/microbatches, ...). Each node's gradient is its
    own loss's (the per-node losses are summed and differentiated once: no
    term couples two nodes). With microbatches > 1 the gradients are summed
    in ``acc_dtype`` and scaled by 1/microbatches. Then the optimizer
    (``adamw.update`` or ``sgd.update``, new trees) and the gossip
    ``mix_fn(w_mix, params)`` (default ``decavg.mix_dense``). ``opt_state``
    comes from ``adamw.init`` or ``sgd.init`` of the stacked params.
    """
    loss_fn = node_loss_fn(cfg, aux_coef=aux_coef)
    opt_update = adamw.update if optimizer == "adamw" else sgd.update
    mix = mix_fn or decavg.mix_dense

    def node_grads(params: PyTree, batch: dict) -> tuple[list[torch.Tensor], torch.Tensor]:
        """Every node's gradient on one microbatch (N, B/mb, ...), and the
        mean of the nodes' losses."""
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        stacked = tree_unflatten(params, leaves)
        with torch.enable_grad():
            losses = torch.stack([
                loss_fn(tree_map(lambda x, i=i: x[i], stacked),
                        {k: v[i] for k, v in batch.items()})
                for i in range(num_nodes)
            ])
            grads = torch.autograd.grad(losses.sum(), leaves)
        return list(grads), losses.detach().mean()

    def all_node_grads(params: PyTree, batch: dict) -> tuple[PyTree, torch.Tensor]:
        if microbatches == 1:
            grads, loss = node_grads(params, {k: v[0] for k, v in batch.items()})
            return tree_unflatten(params, grads), loss
        g_acc = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
                 for p in tree_leaves(params)]
        l_acc = torch.zeros((), dtype=torch.float32, device=g_acc[0].device)
        for m in range(microbatches):
            grads, loss = node_grads(params, {k: v[m] for k, v in batch.items()})
            for a, g in zip(g_acc, grads):
                a.add_(g.to(a.dtype))
            del grads
            l_acc = l_acc + loss
        inv = 1.0 / microbatches
        for a in g_acc:
            a.mul_(inv)
        return tree_unflatten(params, g_acc), l_acc * inv

    def train_step(params: PyTree, opt_state, w_mix: torch.Tensor, batch: dict):
        grads, loss = all_node_grads(params, batch)
        params, opt_state = opt_update(grads, opt_state, params, lr=lr)
        del grads
        with torch.no_grad():
            params = mix(w_mix, params)
        return params, opt_state, loss

    return train_step


def build_prefill_step(cfg: ArchConfig) -> Callable:
    """Inference prefill: full-sequence forward -> the last position's
    greedy token (B,) int32. The batch dict holds ``tokens`` (B, S), and
    ``frames`` (enc-dec) or ``prefix_embeds`` (VLM) where the model reads
    them."""

    @torch.no_grad()
    def prefill_step(params: PyTree, batch: dict) -> torch.Tensor:
        kw = {}
        if cfg.enc_dec:
            kw["memory"] = TF.encode(params, cfg, batch["frames"])
        if "prefix_embeds" in batch:
            kw["prefix_embeds"] = batch["prefix_embeds"]
        logits, _ = TF.forward(params, cfg, batch["tokens"], last_only=True, **kw)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    return prefill_step


def build_serve_step(cfg: ArchConfig, *, window: int | None = None) -> Callable:
    """Single-token decode against an existing cache: serve_step(params,
    token (B,), cache, memory=None) -> (next_token (B,) int32, cache), the
    cache advanced in place (``memory``: an enc-dec model's encoder
    output)."""

    def serve_step(params: PyTree, token: torch.Tensor, cache: PyTree, memory=None):
        logits, cache = TF.decode_step(params, cfg, token, cache, memory=memory,
                                       window=window)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return serve_step
