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

``faults=`` (core/faults.py) runs the faulted round on the dense and sparse
backends: local steps, dead nodes (params and momentum) put back to their
pre-round values, the straggler ring pushed every round, and on gossip rounds
the renormalized mix of the published snapshots. ``compress=`` (a top-k
fraction) turns on CHOCO gossip (core/compress.py): each gossip round every
node publishes the top-k of ``params - reference``, peers mix the shared
references, and ``params += W @ ref - ref``; at ``k_frac = 1`` this is DecAvg.
The two do not compose, as in the reference. In ``run_fused`` every
round-dependent value of a captured graph (the round's alive and keep rows,
the ring's slots) is read on the device from a buffer refilled before each
replay, and the compression reference is a static buffer that only the
gossip rounds' graphs advance.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core import compress as compress_mod
from repro_torch.core import decavg
from repro_torch.core import faults as faults_mod
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
    """DecAvg over a model family (default: the paper's MLP), with every
    node's state stacked on one device.

    ``init_fn(generator)`` returns one node's params (default: ``init_mlp``
    with ``in_dim``/``hidden``/``num_classes``), drawn from a CPU
    ``torch.Generator`` seeded with ``seed``. ``forward_fn(p, x)`` is one
    node's forward pass, mapped over the node axis with ``torch.func.vmap``
    (default: ``mlp_forward`` on the stacked params). ``params``
    (node-stacked tensors) replaces the initialisation, so tests can start
    both packages from the same weights. ``device`` is where everything
    runs; None means CUDA (and raises without a card).
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
        init_fn: Callable[[torch.Generator], PyTree] | None = None,
        forward_fn: Callable[[PyTree, torch.Tensor], torch.Tensor] | None = None,
        in_dim: int = 784,
        hidden: Sequence[int] | None = None,
        num_classes: int = 10,
        class_groups: Sequence[int] | np.ndarray | None = None,
        params: PyTree | None = None,
        device: str | torch.device | None = None,
    ):
        self.engine = decavg.GossipEngine(
            graph, data_sizes=loader.sizes.astype(np.float64), backend=mix_impl,
            matrix=matrix, sparse_p_chunk=sparse_p_chunk, gossip_every=gossip_every,
            faults=faults, seed=seed, n=len(loader.sizes), device=device,
        )
        self.faulted = self.engine.faults is not None
        if self.faulted and compress is not None:
            raise ValueError(
                "faults do not compose with compress= gossip: the CHOCO "
                "reference update assumes every published model is current"
            )
        if compress is not None and not 0.0 < float(compress) <= 1.0:
            raise ValueError(f"compress (top-k fraction) must be in (0, 1], got {compress}")
        self.compress = None if compress is None else float(compress)
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
        self.forward_fn = forward_fn

        if params is None:
            if init_fn is None:
                kw = dict(in_dim=in_dim, num_classes=num_classes)
                if hidden is not None:
                    kw["hidden"] = tuple(hidden)
                init_fn = lambda gen: init_mlp(gen, **kw)  # noqa: E731
            gen = torch.Generator().manual_seed(seed)  # CPU draws: same init on every device
            if same_init:
                p0 = init_fn(gen)
                params = tree_map(lambda x: x.expand(self.num_nodes, *x.shape), p0)
            else:
                nodes = [init_fn(gen) for _ in range(self.num_nodes)]
                params = tree_map(lambda *xs: torch.stack(xs), *nodes)
        self.params = tree_map(lambda x: x.to(self.device).contiguous().clone(), params)
        self.momentum = sgd.init(self.params)
        self.cstate = None if self.compress is None else compress_mod.init(self.params)
        self._has_hist = self.faulted and self.engine.fault_trace.delay_max > 0

    @property
    def graph(self):
        return self.engine.graph

    @property
    def supports_fused(self) -> bool:
        """True when ``run_fused`` can execute this trainer's backend."""
        return self.mix_impl in _FUSED_BACKENDS

    def _forward(self, params: PyTree, x: torch.Tensor, *, shared: bool = False) -> torch.Tensor:
        """(N, B, C) logits of every node: ``x`` is (N, B, ...) per node, or
        one batch every node sees (``shared``)."""
        if self.forward_fn is None:
            return mlp_forward(params, x)
        return torch.func.vmap(self.forward_fn, in_dims=(0, None if shared else 0))(params, x)

    def _sgd_step(self, params: PyTree, momentum: PyTree, x: torch.Tensor,
                  y: torch.Tensor) -> None:
        """One local SGD step on every node, in place on ``params`` and
        ``momentum``."""
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            tracked = _unflatten(params, leaves)
            loss = softmax_xent(self._forward(tracked, x), y).sum()
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
        logits = self._forward(self.params, x_test, shared=True)  # (N, T, C)
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

    def _gossip(self, mix: Callable[[PyTree], PyTree], params: PyTree) -> PyTree:
        """One gossip exchange through ``mix`` (a params -> params closure).

        Without compression this is plain DecAvg. With it, the CHOCO update:
        every node publishes the top-k of ``params - reference`` (advancing
        the reference in place), peers mix the references, and each node
        keeps its residual: ``params + W @ ref - ref``.
        """
        if self.compress is None:
            return mix(params)
        _, state = compress_mod.compress(params, self.cstate, k_frac=self.compress)
        ref = self.cstate.reference
        for r, new in zip(tree_leaves(ref), tree_leaves(state.reference)):
            r.copy_(new)
        mixed = mix(ref)
        return tree_map(lambda p, m, r: (p.float() + (m - r)).to(p.dtype), params, mixed, ref)

    def _gossip_first(self, gossip_first: bool) -> None:
        """The optional mix before round 0, with the current period's W."""
        if not gossip_first:
            return
        if self.faulted:
            raise ValueError(
                "gossip_first does not compose with faults= (there is no "
                "round index for the pre-round mix to draw masks from)"
            )
        with torch.no_grad():
            self.params = self.engine.mix(self.params)

    @staticmethod
    def _report(m: RoundMetrics, verbose: bool) -> None:
        if verbose:
            accs = m.per_node_acc
            print(
                f"round {m.round:4d}  acc mean {accs.mean():.4f} "
                f"std {accs.std():.4f} min {accs.min():.4f} max {accs.max():.4f}"
            )

    def _round_faulted(self, r: int, hist: PyTree, delay: torch.Tensor | None) -> None:
        """One faulted round: train, put dead nodes back to their pre-round
        params and momentum (exactly as if they never trained), push the
        straggler ring (every round), and on gossip rounds mix the published
        snapshots over the surviving renormalized W."""
        alive = torch.as_tensor(self.engine.fault_trace.alive(r), device=self.device)
        p_in = tree_map(torch.clone, self.params)
        o_in = tree_map(torch.clone, self.momentum)
        self._local_steps(r)
        with torch.no_grad():
            self.params = faults_mod.where_alive(alive, self.params, p_in)
            self.momentum = faults_mod.where_alive(alive, self.momentum, o_in)
            pub = None
            if hist is not None:
                pub, _ = faults_mod.push_and_publish(self.params, hist, r, delay)
            if self.engine.is_gossip_round(r):
                self.engine.refresh(r)
                self.params = self.engine.mix_faulted(self.params, r, pub)

    def run(
        self,
        rounds: int,
        *,
        eval_every: int = 1,
        x_test: np.ndarray | None = None,
        y_test: np.ndarray | None = None,
        gossip_first: bool = False,
        verbose: bool = False,
        on_round: Callable[[RoundMetrics], None] | None = None,
    ) -> list[RoundMetrics]:
        """Run communication rounds; returns the per-round metrics history.

        Each round trains locally, gossips on the engine's gossip rounds, and
        evaluates on the reference's cadence (``r % eval_every == 0`` or the
        last round) when ``x_test`` is given. ``gossip_first`` mixes once
        before round 0; ``verbose`` prints a line per evaluation.
        ``on_round`` fires after every evaluated round.
        """
        history: list[RoundMetrics] = []
        t0 = time.perf_counter()
        self._gossip_first(gossip_first)
        hist = delay = None
        if self.faulted:
            self.engine.fault_trace.ensure(rounds)
            delay = self.engine.fault_delay()
            if self._has_hist:
                hist = faults_mod.init_history(
                    self.params, self.engine.fault_trace.delay_max + 1
                )
        for r in range(rounds):
            if self.faulted:
                self._round_faulted(r, hist, delay)
            else:
                self._local_steps(r)
                if self.engine.is_gossip_round(r):
                    self.engine.refresh(r)
                    with torch.no_grad():
                        self.params = self._gossip(self.engine.mix, self.params)
            if x_test is not None and (r % eval_every == 0 or r == rounds - 1):
                m = self.eval_round(r, x_test, y_test, t0)
                history.append(m)
                if on_round is not None:
                    on_round(m)
                self._report(m, verbose)
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
        gossip_first: bool = False,
        verbose: bool = False,
        on_round: Callable[[RoundMetrics], None] | None = None,
    ) -> list[RoundMetrics]:
        """``run`` from a staged program: on the card, captured CUDA graphs.

        Every schedule period (and, with faults, every round's masks) is
        staged up front (``GossipEngine.program``). Rounds go in chunks that
        end at the eval rounds (``run``'s cadence); a chunk's batch indices
        are drawn before it runs (the same draws as ``run``), and each round
        replays the local-step graph and, on gossip rounds, the mix graph of
        its period slot. Metrics stream to ``on_round`` after each chunk.
        Without ``x_test`` the run is one chunk. Supported for the dense,
        sparse and sparse_pallas backends; others raise (use ``run``). A
        capture that fails on the card raises.
        """
        if not self.supports_fused:
            raise ValueError(
                f"run_fused supports backends {_FUSED_BACKENDS}, not "
                f"{self.mix_impl!r}; use run()"
            )
        if rounds < 1:
            return []
        program = self.engine.program(rounds, kind=self.mix_impl)
        t0 = time.perf_counter()
        self._gossip_first(gossip_first)
        steps = self.loader.steps_per_epoch() * self.local_epochs
        staged = _FusedRounds(self, program, steps)
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
                    self._report(m, verbose)
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
    back), the compression reference (``trainer.cstate``), ``idx``, the
    round's (steps, N, B) batch positions, and ``r``, the round itself as an
    int64 tensor; both are refilled before each round. On a faulted program
    the graphs also hold the pre-round snapshots ``p_in``/``o_in`` and the
    straggler ring ``hist``, and read the round's alive and keep rows and the
    ring's slots through ``r`` on the device. On the card each piece is
    captured on first use: the local steps once, the mix once per period
    slot.
    """

    def __init__(self, trainer: DecentralizedTrainer, program: decavg.MixingProgram, steps: int):
        self.trainer = trainer
        self.program = program
        self.steps = steps
        dev = trainer.device
        self.device = dev
        self.idx = torch.zeros((steps, trainer.num_nodes, trainer.loader.batch),
                               dtype=torch.int64, device=dev)
        self.r = torch.zeros((), dtype=torch.int64, device=dev)
        self.hist = None
        if program.faulted:
            self.p_in = tree_map(torch.empty_like, trainer.params)
            self.o_in = tree_map(torch.empty_like, trainer.momentum)
            if program.delay_max > 0:
                self.hist = faults_mod.init_history(trainer.params, program.delay_max + 1)
        self.local: Staged | None = None
        self.mix: dict[int, Staged] = {}
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        # The graphs run one after another on one stream and keep nothing
        # alive between replays, so they can share one memory pool.
        self.pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None

    def _local_steps(self) -> None:
        tr = self.trainer
        if self.program.faulted:
            _copy_into(self.p_in, tr.params)
            _copy_into(self.o_in, tr.momentum)
        for s in range(self.steps):
            x, y = tr.loader.batch_at(self.idx[s])
            tr._sgd_step(tr.params, tr.momentum, x, y)
        if self.program.faulted:
            with torch.no_grad():
                alive = self.program.alive_at(self.r)
                _copy_into(tr.params, faults_mod.where_alive(alive, tr.params, self.p_in))
                _copy_into(tr.momentum, faults_mod.where_alive(alive, tr.momentum, self.o_in))
                if self.hist is not None:
                    faults_mod.push(tr.params, self.hist, self.r)

    @torch.no_grad()
    def _mix(self, t: int) -> None:
        tr = self.trainer
        if self.program.faulted:
            pub = (None if self.hist is None
                   else faults_mod.publish(self.hist, self.r, self.program.f_delay))
            mixed = self.program.apply_period(tr.params, t, r=self.r, pub=pub)
        else:
            mixed = tr._gossip(lambda q: self.program.apply_period(q, t), tr.params)
        _copy_into(tr.params, mixed)

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
                self.program.apply_period(params, 0, r=self.r)
            if tr.compress is not None:
                compress_mod.compress(params, compress_mod.init(params), k_frac=tr.compress)
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
        self.r.fill_(r)
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


def _copy_into(dst: PyTree, src: PyTree) -> None:
    """Copy ``src``'s leaves into ``dst``'s tensors (static buffers)."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        d.copy_(s)
