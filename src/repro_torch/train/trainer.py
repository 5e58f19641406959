"""Paper-faithful decentralized trainer (DecAvg over a graph of nodes).

One *communication round* (paper §3):
  1. every node runs local SGD-with-momentum steps on its own data,
  2. every node replaces its weights by the Eq. 1 neighborhood average.

All nodes advance in lockstep as node-stacked parameter trees. A local step
computes one loss, the sum over nodes of each node's mean cross-entropy, so
``torch.autograd.grad`` with respect to the stacked parameters gives every
node its own gradient, exactly (no term couples two nodes). The gossip is a
``GossipEngine`` round (core/decavg.py). Momentum is node-local and is *not*
averaged: the paper gossips model weights only.

This slice ports the reference's per-round loop, ``run``. ``run_fused``
(the reference's single-``lax.scan`` path) is not ported yet, so
``supports_fused`` is False; ``compress=`` and ``faults=`` raise.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core import decavg
from repro_torch.core.topology import Graph, TopologySchedule
from repro_torch.data.loader import NodeLoader
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.optim import sgd
from repro_torch.train.losses import softmax_xent
from repro_torch.train.metrics import (
    accuracy,
    confusion_matrix,
    consensus_distance,
    group_accuracy,
)
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

__all__ = ["DecentralizedTrainer", "RoundMetrics"]


@dataclasses.dataclass
class RoundMetrics:
    round: int
    per_node_acc: np.ndarray  # (N,)
    mean_acc: float
    std_acc: float
    group_acc: np.ndarray | None = None  # (N, G) per-node per-group accuracy
    consensus: np.ndarray | None = None  # (N,) ||theta_i - theta_bar||
    wall_s: float = 0.0  # cumulative wall-clock since run() started


class DecentralizedTrainer:
    """DecAvg over the paper's MLP, with every node's state stacked on one
    device.

    ``params`` (node-stacked tensors) replaces the seeded initialisation, so
    tests can start both packages from the same weights. ``device`` is where
    everything runs; None means CUDA (and raises without a card).
    """

    def __init__(
        self,
        graph: Graph | TopologySchedule | str,
        loader: NodeLoader,
        *,
        lr: float = 1e-3,
        momentum: float = 0.5,
        local_epochs: int = 1,
        mix_impl: str = "dense",  # GossipEngine backend ("dense"|"pallas") or "auto"
        matrix: str = "decavg",
        gossip_every: int = 1,  # mix on rounds r % k == 0; 0 = isolated (no gossip)
        compress: float | None = None,
        faults: str | None = None,
        same_init: bool = True,
        seed: int = 0,
        in_dim: int = 784,
        hidden: Sequence[int] | None = None,
        num_classes: int = 10,
        class_groups: Sequence[int] | np.ndarray | None = None,
        params: PyTree | None = None,
        device: str | torch.device | None = None,
    ):
        if compress is not None:
            raise NotImplementedError("compress= (CHOCO gossip): slice C")
        if faults is not None:
            raise NotImplementedError("faults: slice C")
        self.engine = decavg.GossipEngine(
            graph, data_sizes=loader.sizes.astype(np.float64), backend=mix_impl,
            matrix=matrix, gossip_every=gossip_every, seed=seed,
            n=len(loader.sizes), device=device,
        )
        self.device = self.engine.device
        if loader.device != self.device:
            raise ValueError(f"loader on {loader.device}, trainer on {self.device}")
        self.loader = loader
        self.mix_impl = self.engine.backend
        self.lr, self.mu = lr, momentum
        self.local_epochs = local_epochs
        self.num_nodes = self.engine.num_nodes
        self.num_classes = num_classes
        self.class_groups = (
            None if class_groups is None
            else torch.as_tensor(np.asarray(class_groups), dtype=torch.int64, device=self.device)
        )
        self.num_groups = 0 if class_groups is None else int(np.asarray(class_groups).max()) + 1

        if params is None:
            gen = torch.Generator().manual_seed(seed)  # CPU draws: same init on every device
            kw = dict(in_dim=in_dim, num_classes=num_classes)
            if hidden is not None:
                kw["hidden"] = tuple(hidden)
            if same_init:
                p0 = init_mlp(gen, **kw)
                params = tree_map(lambda x: x.expand(self.num_nodes, *x.shape), p0)
            else:
                nodes = [init_mlp(gen, **kw) for _ in range(self.num_nodes)]
                params = tree_map(lambda *xs: torch.stack(xs), *nodes)
        self.params = tree_map(lambda x: x.to(self.device).contiguous().clone(), params)
        self.momentum = sgd.init(self.params)

    @property
    def graph(self):
        return self.engine.graph

    @property
    def supports_fused(self) -> bool:
        """``run_fused`` is not ported yet; the runner takes ``run``."""
        return False

    def _local_steps(self, r: int) -> None:
        """One round of local SGD steps on every node, in place."""
        steps = self.loader.steps_per_epoch() * self.local_epochs
        for x, y in self.loader.batches(r, steps):
            leaves = [p.detach().requires_grad_(True) for p in tree_leaves(self.params)]
            with torch.enable_grad():
                tracked = _unflatten(self.params, leaves)
                loss = softmax_xent(mlp_forward(tracked, x), y).sum()
                grads = torch.autograd.grad(loss, leaves)
            sgd.update_(list(grads), tree_leaves(self.momentum), tree_leaves(self.params),
                        lr=self.lr, mu=self.mu)

    @torch.no_grad()
    def _eval(self, x_test: torch.Tensor, y_test: torch.Tensor):
        logits = mlp_forward(self.params, x_test)  # (N, T, C)
        accs = accuracy(logits, y_test)
        gaccs = (
            None if self.class_groups is None
            else group_accuracy(logits, y_test, self.class_groups, self.num_groups)
        )
        return accs, gaccs, logits

    def eval_round(self, r: int, x_test, y_test, t0: float) -> RoundMetrics:
        """One evaluation pass over the current params as a RoundMetrics."""
        x_t = torch.as_tensor(np.asarray(x_test), device=self.device)
        y_t = torch.as_tensor(np.asarray(y_test), dtype=torch.int64, device=self.device)
        accs, gaccs, _ = self._eval(x_t, y_t)
        accs = accs.cpu().numpy()
        with torch.no_grad():
            cons = consensus_distance(self.params).cpu().numpy()
        return RoundMetrics(
            r, accs, float(accs.mean()), float(accs.std()),
            group_acc=None if gaccs is None else gaccs.cpu().numpy(),
            consensus=cons, wall_s=time.perf_counter() - t0,
        )

    def run(
        self,
        rounds: int,
        *,
        eval_every: int = 1,
        x_test: np.ndarray | None = None,
        y_test: np.ndarray | None = None,
        on_round: Callable[[RoundMetrics], None] | None = None,
    ) -> list[RoundMetrics]:
        """Run communication rounds; returns the per-round metrics history.

        Each round trains locally, gossips on the engine's gossip rounds, and
        evaluates on the reference's cadence (``r % eval_every == 0`` or the
        last round) when ``x_test`` is given. ``on_round`` fires after every
        evaluated round.
        """
        history: list[RoundMetrics] = []
        t0 = time.perf_counter()
        for r in range(rounds):
            self._local_steps(r)
            with torch.no_grad():
                self.params = self.engine.mix(self.params, round=r)
            if x_test is not None and (r % eval_every == 0 or r == rounds - 1):
                m = self.eval_round(r, x_test, y_test, t0)
                history.append(m)
                if on_round is not None:
                    on_round(m)
        return history

    def confusion(self, x_test: np.ndarray, y_test: np.ndarray) -> np.ndarray:
        """(N, C, C) per-node row-normalized confusion matrices."""
        x_t = torch.as_tensor(np.asarray(x_test), device=self.device)
        y_t = torch.as_tensor(np.asarray(y_test), dtype=torch.int64, device=self.device)
        _, _, logits = self._eval(x_t, y_t)
        return confusion_matrix(logits, y_t, self.num_classes).cpu().numpy()


def _unflatten(tree: PyTree, leaves: list[torch.Tensor]) -> PyTree:
    """``tree``'s structure with ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
