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

Two execution paths over the same numerics, as in the reference:

- ``run``: one Python iteration per round, every operation launched eagerly.
- ``run_fused``: the engine's ``MixingProgram`` stages every schedule period
  on the device up front, each chunk's batch indices are drawn before the
  chunk runs, and on the card a round is two CUDA graphs, captured once and
  replayed: the local steps, and the mix of the round's period slot (the
  host knows the slot and the cadence of every round, so it picks the graph;
  the reference selects both inside one ``lax.scan``). Metrics stream to
  ``on_round`` at the same rounds as ``run``. Same seed gives the same
  params as ``run`` (the tests hold them to 1e-6, and to the bit for the
  sparse backend). On the CPU the same staged rounds run eagerly.

``compress=`` and ``faults=`` raise (slice E).
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
from repro_torch.graphs import Staged
from repro_torch.kernels import sparse_gossip
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

# Backends run_fused supports: those whose per-period operators stack into a
# MixingProgram. Mirrors the ``fused`` flags of GossipEngine.capabilities().
_FUSED_BACKENDS = ("dense", "sparse", "sparse_pallas")


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
        mix_impl: str = "dense",  # a GossipEngine backend or "auto"
        matrix: str = "decavg",
        sparse_p_chunk: int | str | None = None,  # int | "auto": bound the sparse gather transient
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
            raise NotImplementedError("compress= (CHOCO gossip): slice E")
        if faults is not None:
            raise NotImplementedError("faults: slice E")
        self.engine = decavg.GossipEngine(
            graph, data_sizes=loader.sizes.astype(np.float64), backend=mix_impl,
            matrix=matrix, sparse_p_chunk=sparse_p_chunk, gossip_every=gossip_every,
            seed=seed, n=len(loader.sizes), device=device,
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
        """True when ``run_fused`` can execute this trainer's backend."""
        return self.mix_impl in _FUSED_BACKENDS

    def _sgd_step(self, params: PyTree, momentum: PyTree, x: torch.Tensor,
                  y: torch.Tensor) -> None:
        """One local SGD step on every node, in place on ``params`` and
        ``momentum``."""
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            tracked = _unflatten(params, leaves)
            loss = softmax_xent(mlp_forward(tracked, x), y).sum()
            grads = torch.autograd.grad(loss, leaves)
        sgd.update_(list(grads), tree_leaves(momentum), tree_leaves(params),
                    lr=self.lr, mu=self.mu)

    def _local_steps(self, r: int) -> None:
        """One round of local SGD steps on every node, in place."""
        steps = self.loader.steps_per_epoch() * self.local_epochs
        for x, y in self.loader.batches(r, steps):
            self._sgd_step(self.params, self.momentum, x, y)

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

    @staticmethod
    def _eval_rounds(rounds: int, eval_every: int) -> list[int]:
        """Rounds after which both run paths evaluate and stream metrics."""
        return [r for r in range(rounds) if r % eval_every == 0 or r == rounds - 1]

    def run_fused(
        self,
        rounds: int,
        *,
        eval_every: int = 1,
        x_test: np.ndarray | None = None,
        y_test: np.ndarray | None = None,
        on_round: Callable[[RoundMetrics], None] | None = None,
    ) -> list[RoundMetrics]:
        """``run`` from a staged program: on the card, captured CUDA graphs.

        Every schedule period is staged up front (``GossipEngine.program``).
        Rounds go in chunks that end at the eval rounds (``run``'s cadence);
        a chunk's batch indices are drawn before it runs (the same draws as
        ``run``), and each round replays the local-step graph and, on gossip
        rounds, the mix graph of its period slot. Metrics stream to
        ``on_round`` after each chunk. Without ``x_test`` the run is one
        chunk. Supported for the dense, sparse and sparse_pallas backends;
        others raise (use ``run``). A capture that fails on the card raises.
        """
        if not self.supports_fused:
            raise ValueError(
                f"run_fused supports backends {_FUSED_BACKENDS}, not "
                f"{self.mix_impl!r}; use run()"
            )
        if rounds < 1:
            return []
        t0 = time.perf_counter()
        steps = self.loader.steps_per_epoch() * self.local_epochs
        staged = _FusedRounds(self, self.engine.program(rounds, kind=self.mix_impl), steps)
        do_eval = x_test is not None
        ends = self._eval_rounds(rounds, eval_every) if do_eval else [rounds - 1]
        history: list[RoundMetrics] = []
        start = 0
        try:
            for end in ends:
                idx = self.loader.chunk_indices(start, end - start + 1, steps)
                for i, r in enumerate(range(start, end + 1)):
                    staged.round(r, idx[i])
                start = end + 1
                if do_eval:
                    m = self.eval_round(end, x_test, y_test, t0)
                    history.append(m)
                    if on_round is not None:
                        on_round(m)
        finally:
            staged.close()
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


class _FusedRounds:
    """The rounds of one ``run_fused`` call, staged on the trainer's state.

    The static buffers are the trainer's own parameter and momentum tensors
    (updated in place: the local steps by SGD, the mix by copying its result
    back) and ``idx``, the round's (steps, N, B) batch positions, refilled
    before each round. On the card each piece is captured on first use: the
    local steps once, the mix once per period slot.
    """

    def __init__(self, trainer: DecentralizedTrainer, program: decavg.MixingProgram, steps: int):
        self.trainer = trainer
        self.program = program
        self.steps = steps
        dev = trainer.device
        self.device = dev
        self.idx = torch.zeros((steps, trainer.num_nodes, trainer.loader.batch),
                               dtype=torch.int64, device=dev)
        self.local: Staged | None = None
        self.mix: dict[int, Staged] = {}
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        # The graphs run one after another on one stream and keep nothing
        # alive between replays, so they can share one memory pool.
        self.pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None

    def _local_steps(self) -> None:
        tr = self.trainer
        for s in range(self.steps):
            x, y = tr.loader.batch_at(self.idx[s])
            tr._sgd_step(tr.params, tr.momentum, x, y)

    @torch.no_grad()
    def _mix(self, t: int) -> None:
        params = self.trainer.params
        mixed = self.program.apply_period(params, t)
        for p, m in zip(tree_leaves(params), tree_leaves(mixed)):
            p.copy_(m)

    def _warm_up(self) -> None:
        """Run the round's operations on scratch copies on the capture stream,
        so lazy initialisation happens before capture. The sparse_pallas mix
        is the CUDA kernel alone: its module is loaded, not launched, so no
        warm-up launch is counted against the run."""
        tr = self.trainer
        params = tree_map(torch.clone, tr.params)
        momentum = tree_map(torch.clone, tr.momentum)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            for _ in range(2):
                for s in range(self.steps):
                    x, y = tr.loader.batch_at(self.idx[s])
                    tr._sgd_step(params, momentum, x, y)
            if self.program.kind == "sparse_pallas":
                sparse_gossip.load()
            else:
                self.program.apply_period(params, 0)
        torch.cuda.current_stream(self.device).wait_stream(self.stream)

    def _stage(self, fn) -> Staged:
        return Staged(fn, self.device, stream=self.stream, pool=self.pool)

    def close(self) -> None:
        """Release the graphs now. They hold closures over this object, so
        left to the cyclic garbage collector they could be destroyed during
        a later capture, which a CUDA graph's destruction would break."""
        self.local = None
        self.mix.clear()

    def round(self, r: int, idx: torch.Tensor) -> None:
        """Round ``r`` with batch positions ``idx`` (steps, N, B)."""
        self.idx.copy_(idx)
        if self.local is None:
            if self.stream is not None:
                self._warm_up()
            self.local = self._stage(self._local_steps)
        self.local()
        if not self.program.gossip_mask[r]:
            return
        t = int(self.program.period_idx[r])
        if t not in self.mix:
            self.mix[t] = self._stage(lambda: self._mix(t))
        self.mix[t]()
