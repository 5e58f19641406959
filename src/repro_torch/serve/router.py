"""Topology-aware routing: send each query to the cohort node that knows.
The port of ``repro/serve/router.py``.

The paper's core result is that topology shapes where knowledge ends up:
hubs absorb G2 (foreign-domain) patterns that leaves never see. At serving
time that asymmetry is actionable: a query about domain d should go to the
node whose model best covers d, which after gossip on a star or scale-free
graph is typically a hub, not the node that owns d's training stream.

``CohortRouter`` loads a trained cohort from the LM trainer's checkpoint
(params only: the AdamW moments stay on disk, ``ckpt.restore_subtree``),
builds a (nodes x domains) coverage table by scoring every node's model on
every domain's held-out query stream (the trainer's ``domain_acc``
quantity: mean true-next-token probability), and routes each query to
``argmax_node coverage[node, domain(query)]``. A query's domain is the
node-domain set (``data/tokens.node_domain``) it overlaps most.

Policies (``route=``): ``"best"`` (coverage argmax), ``"round_robin"``
(topology-blind baseline), or an int node id (pinned).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data import tokens as tok
from repro_torch.device import resolve_device
from repro_torch.models import transformer as TF
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["CohortRouter", "load_cohort", "stacked_params_like"]

PyTree = Any


def stacked_params_like(cfg: ArchConfig, nodes: int) -> PyTree:
    """A node-stacked ((N, ...) leaves) param tree on the ``meta`` device:
    the ``like`` of a params-only restore, with no memory and no init."""
    per = TF.init_params(None, cfg, device="meta")
    return tree_map(lambda x: x.expand(nodes, *x.shape), per)


def load_cohort(path: str, cfg: ArchConfig, *, nodes: int,
                device: str | torch.device | None = None) -> tuple[PyTree, int | None]:
    """Node-stacked params from an ``LMCohortTrainer.save`` checkpoint, on
    ``device`` (None: the card), without reading the optimizer moments.
    Returns (params, step)."""
    from repro_torch.checkpoint import ckpt

    return ckpt.restore_subtree(path, stacked_params_like(cfg, nodes), prefix="params",
                                device=resolve_device(device))


@torch.no_grad()
def _coverage(params: PyTree, cfg: ArchConfig, toks: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """(N-stacked params) x (D, B, S) queries -> (N, D) mean true-token
    probability of node i's model on domain j's query stream."""
    n, d = tree_leaves(params)[0].shape[0], toks.shape[0]
    out = torch.empty((n, d), dtype=torch.float32, device=toks.device)
    for i in range(n):
        p = tree_map(lambda x: x[i], params)
        for j in range(d):
            logits, _ = TF.forward(p, cfg, toks[j])
            logp = torch.log_softmax(logits.float(), dim=-1)
            ll = logp.gather(-1, labels[j].long().unsqueeze(-1)).squeeze(-1)
            out[i, j] = torch.exp(ll).mean()
    return out


class CohortRouter:
    """Routes queries over a trained cohort's node-stacked params::

        router = CohortRouter.from_checkpoint(path, cfg, nodes=8, seed=0)
        node = router.route(query_tokens)            # coverage argmax
        node = router.route(query_tokens, route="round_robin")
        params_i = router.node_params(node)          # feed Engine / generate
    """

    def __init__(
        self,
        params: PyTree,
        cfg: ArchConfig,
        *,
        seed: int = 0,
        domain_size: int = 64,
        coverage_batch: int = 4,
        coverage_seq: int = 16,
    ):
        self.params = params
        self.cfg = cfg
        self.nodes = int(tree_leaves(params)[0].shape[0])
        self.seed = seed
        self.domains = np.stack([
            tok.node_domain(i, cfg.vocab_size, seed=seed, domain_size=domain_size)
            for i in range(self.nodes)
        ])  # (N, domain_size): domain j is node j's boosted token set
        qt, ql = zip(*(
            tok.domain_query_batch(j, coverage_batch, coverage_seq, cfg.vocab_size,
                                   seed=seed, domain_size=domain_size)
            for j in range(self.nodes)
        ))
        dev = tree_leaves(params)[0].device
        self.coverage = _coverage(
            params, cfg, torch.as_tensor(np.stack(qt), device=dev),
            torch.as_tensor(np.stack(ql), device=dev),
        ).cpu().numpy()  # (N nodes, D domains)
        self._rr = 0

    @classmethod
    def from_checkpoint(cls, path: str, cfg: ArchConfig, *, nodes: int, seed: int = 0,
                        device: str | torch.device | None = None, **kw) -> "CohortRouter":
        params, _ = load_cohort(path, cfg, nodes=nodes, device=device)
        return cls(params, cfg, seed=seed, **kw)

    def classify(self, query) -> int:
        """Domain id of a query: the node-domain set with the largest token
        overlap (ties break toward the lower id)."""
        q = np.asarray(query).reshape(-1)
        hits = (self.domains[:, :, None] == q[None, None, :]).any(axis=1)
        return int(hits.sum(axis=1).argmax())

    def route(self, query, *, route: str | int = "best", exclude=()) -> int:
        """The serving node for one query under the given policy.

        ``exclude``: node ids unavailable for this query. With the domain's
        owner excluded, "best" falls through to whichever node gossip pushed
        that domain's knowledge to (on a star, the hub).
        """
        excluded = set(int(e) for e in exclude)
        if len(excluded) >= self.nodes:
            raise ValueError("every node excluded")
        if isinstance(route, (int, np.integer)):
            if not 0 <= route < self.nodes:
                raise ValueError(f"node id {route} out of range [0, {self.nodes})")
            return int(route)
        if route == "round_robin":
            while True:
                n, self._rr = self._rr, (self._rr + 1) % self.nodes
                if n not in excluded:
                    return n
        if route == "best":
            cov = self.coverage[:, self.classify(query)].copy()
            if excluded:
                cov[list(excluded)] = -np.inf
            return int(cov.argmax())
        raise ValueError(f"route must be 'best', 'round_robin' or a node id, got {route!r}")

    def node_params(self, node: int) -> PyTree:
        """One node's param tree (the leading N axis sliced off): what
        ``Engine`` and ``decode.generate`` take."""
        return tree_map(lambda x: x[node], self.params)
