"""Decentralized trainers: the paper's DecAvg over a graph of nodes
(``DecentralizedTrainer``), and the same over a cohort of transformer LMs
(``LMCohortTrainer``, below).

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
  sparse and sparse_sharded backends). On the CPU the same staged rounds
  run eagerly.

The mesh backends (``sharded``, ``sparse_sharded``, ``permute``) mix over
the engine's ``core.mesh.Mesh`` (default: one shard per local card, one on
the CPU), whose shards may sit on several devices; the trainer's device,
the home of ``params``, ``w`` and the metrics, must be one of them.
``DecentralizedTrainer.run`` keeps the state on that device, and each mix
moves the slabs out and back (``LMCohortTrainer`` holds its cohort sharded
on ``sparse_sharded`` instead; see its docstring).
``run_fused`` on ``sparse_sharded`` keeps the state sharded end to end, as
the reference's ``_scan_rounds_sharded``: each shard's slab of the params,
momentum, CHOCO reference and fault state lives on its own device for the
whole call and trains there, and the halo exchange of the mix is the only
traffic between shards (``_ShardedFusedRounds``). Each local step is
elementwise over nodes, so a slab's steps give the bits of the whole
node axis's.

``faults=`` (core/faults.py) runs the faulted round on the dense, sparse and
sparse_sharded backends: local steps, dead nodes (params and momentum) put back to their
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
from repro_torch.core import mesh as mesh_mod
from repro_torch.core.topology import Graph, TopologySchedule
from repro_torch.data.loader import NodeLoader
from repro_torch.graphs import Staged
from repro_torch.kernels import ell_sum, sparse_gossip
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as TF
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.optim import adamw, schedules, sgd
from repro_torch.spans import span
from repro_torch.train.losses import softmax_xent
from repro_torch.train.metrics import (
    accuracy,
    confusion_matrix,
    consensus_distance,
    group_accuracy,
    sharded_consensus_distance,
)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any

__all__ = ["DecentralizedTrainer", "LMCohortTrainer", "RoundMetrics"]

# Backends run_fused supports: those whose per-period operators stack into a
# MixingProgram. Mirrors the ``fused`` flags of GossipEngine.capabilities().
_FUSED_BACKENDS = ("dense", "sparse", "sparse_pallas", "sparse_sharded")


def _check_mesh(engine: decavg.GossipEngine, device: torch.device) -> None:
    """A mesh backend runs over a mesh that holds the trainer's device, the
    home device where ``params``, ``w`` and the metrics live; its shards may
    sit on other devices too (a shard per card), or repeat one."""
    if engine.mesh is None or engine.backend not in decavg._MESH_BACKENDS:
        return
    if not any(mesh_mod.same_device(d, device) for d in engine.mesh.device_set):
        devices = sorted(str(d) for d in engine.mesh.device_set)
        raise ValueError(f"mesh on {', '.join(devices)}, trainer on {device}")


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
    node's state stacked on its device (between ``run_fused`` calls on
    ``sparse_sharded`` too).

    ``init_fn(generator)`` returns one node's params (default: ``init_mlp``
    with ``in_dim``/``hidden``/``num_classes``), drawn from a CPU
    ``torch.Generator`` seeded with ``seed``. ``forward_fn(p, x)`` is one
    node's forward pass, mapped over the node axis with ``torch.func.vmap``
    (default: ``mlp_forward`` on the stacked params). ``params``
    (node-stacked tensors) replaces the initialisation, so tests can start
    both packages from the same weights. ``mesh`` (a ``core.mesh.Mesh``
    holding the trainer's device) is the engine's, for the mesh backends;
    without one, sparse_sharded takes the engine's default mesh. ``device``
    is the home of the state and metrics; None means CUDA (and raises
    without a card).
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
        mesh: mesh_mod.Mesh | None = None,
        device: str | torch.device | None = None,
    ):
        self.engine = decavg.GossipEngine(
            graph, data_sizes=loader.sizes.astype(np.float64), backend=mix_impl,
            matrix=matrix, sparse_p_chunk=sparse_p_chunk, gossip_every=gossip_every,
            faults=faults, seed=seed, mesh=mesh, n=len(loader.sizes), device=device,
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
        self.momentum = sgd.init(self.params).momentum
        self.cstate = None if self.compress is None else compress_mod.init(self.params)
        self._has_hist = self.faulted and self.engine.fault_trace.delay_max > 0
        # The dense (N, N) W of the schedule period the trainer is in, as the
        # reference keeps it; refreshed by _enter_period.
        self.w = self.engine.w

    @property
    def graph(self):
        return self.engine.graph

    def _enter_period(self, r: int) -> None:
        """Move the engine, and ``w``, to round ``r``'s schedule period."""
        if self.engine.refresh(r):
            self.w = self.engine.w

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
            tracked = tree_unflatten(params, leaves)
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
    def _eval(self, params: PyTree, x_test: torch.Tensor, y_test: torch.Tensor,
              groups: torch.Tensor | None):
        logits = self._forward(params, x_test, shared=True)  # (N, T, C)
        accs = accuracy(logits, y_test)
        gaccs = None if groups is None else group_accuracy(logits, y_test, groups, self.num_groups)
        return accs, gaccs, logits

    def _test_set(self, x_test, y_test, device: torch.device):
        return (torch.as_tensor(np.asarray(x_test), device=device),
                torch.as_tensor(np.asarray(y_test), dtype=torch.int64, device=device),
                None if self.class_groups is None else self.class_groups.to(device))

    def eval_round(self, r: int, x_test, y_test, t0: float,
                   slabs: list[PyTree] | None = None) -> RoundMetrics:
        """One evaluation pass over the current params as a RoundMetrics.
        ``slabs`` (a sharded run's per-shard param trees, each on its
        shard's device) are evaluated where they live, and only the metrics
        come to the trainer's device, in node order."""
        with span("trainer.eval", round=r):
            parts = [self.params] if slabs is None else slabs
            test_sets: dict[torch.device, tuple] = {}
            accs, gaccs = [], []
            for p in parts:
                dev = tree_leaves(p)[0].device
                if dev not in test_sets:
                    with span("eval.test_set"):
                        test_sets[dev] = self._test_set(x_test, y_test, dev)
                a, g, _ = self._eval(p, *test_sets[dev])
                accs.append(a)
                gaccs.append(g)
            acc = mesh_mod.gather(accs, self.device).cpu().numpy()
            with torch.no_grad():
                cons = (consensus_distance(self.params) if slabs is None
                        else sharded_consensus_distance(slabs, self.device)).cpu().numpy()
            return RoundMetrics(
                r, acc, float(acc.mean()), float(acc.std()),
                group_acc=(None if self.class_groups is None
                           else mesh_mod.gather(gaccs, self.device).cpu().numpy()),
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
        _check_mesh(self.engine, self.device)
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
            self._enter_period(r)
            if self.faulted:
                self._round_faulted(r, hist, delay)
            else:
                self._local_steps(r)
                if self.engine.is_gossip_round(r):
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
        sparse, sparse_pallas and sparse_sharded backends; others raise (use
        ``run``). A capture that fails on the card raises. The call, its
        staging, chunks, rounds, each piece's eager run, capture and replay
        and its evaluations are spans (``repro_torch.spans``).
        """
        if not self.supports_fused:
            raise ValueError(
                f"run_fused supports backends {_FUSED_BACKENDS}, not "
                f"{self.mix_impl!r}; use run()"
            )
        _check_mesh(self.engine, self.device)
        if rounds < 1:
            return []
        with span("fused.call", rounds=rounds, backend=self.mix_impl):
            with span("fused.program"):
                program = self.engine.program(rounds, kind=self.mix_impl)
            t0 = time.perf_counter()
            self._gossip_first(gossip_first)
            steps = self.loader.steps_per_epoch() * self.local_epochs
            sharded = program.kind == "sparse_sharded"
            with span("fused.stage"):
                staged = (_ShardedFusedRounds if sharded else _FusedRounds)(self, program, steps)
            do_eval = x_test is not None
            ends = self._eval_rounds(rounds, eval_every) if do_eval else [rounds - 1]
            history: list[RoundMetrics] = []
            start = 0
            try:
                for end in ends:
                    with span("fused.chunk"):
                        staged.chunk(self.loader.chunk_indices(start, end - start + 1, steps))
                    for i, r in enumerate(range(start, end + 1)):
                        with span("fused.round", round=r):
                            staged.round(r, i)
                    start = end + 1
                    self._enter_period(end)
                    if do_eval:
                        m = self.eval_round(end, x_test, y_test, t0,
                                            slabs=staged.param_slabs() if sharded else None)
                        history.append(m)
                        if on_round is not None:
                            on_round(m)
                        self._report(m, verbose)
                if sharded:
                    with span("fused.gather"):
                        staged.gather()
            finally:
                with span("fused.close"):
                    staged.close()
            return history

    def confusion(self, x_test: np.ndarray, y_test: np.ndarray) -> np.ndarray:
        """(N, C, C) per-node row-normalized confusion matrices."""
        x_t, y_t, groups = self._test_set(x_test, y_test, self.device)
        _, _, logits = self._eval(self.params, x_t, y_t, groups)
        return confusion_matrix(logits, y_t, self.num_classes).cpu().numpy()


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
        and the unfaulted sparse mix are a hand-written kernel alone: its
        module is loaded, not launched, so no warm-up launch is counted
        against the run. A faulted sparse mix (masks and renormalisation in
        plain PyTorch around the ELL sums) is warmed up whole."""
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
                sparse_gossip.load(self.device)
            elif self.program.kind == "sparse" and not self.program.faulted:
                ell_sum.load(self.device)
            else:
                self.program.apply_period(params, 0, r=self.r)
            if tr.compress is not None:
                compress_mod.compress(params, compress_mod.init(params), k_frac=tr.compress)
        torch.cuda.current_stream(self.device).wait_stream(self.stream)

    def _stage(self, fn, **attrs) -> Staged:
        return Staged(fn, self.device, stream=self.stream, pool=self.pool, attrs=attrs)

    def close(self) -> None:
        """Release the graphs now. They hold closures over this object, so
        left to the cyclic garbage collector they could be destroyed during
        a later capture, which a CUDA graph's destruction would break."""
        self.local = None
        self.mix.clear()

    def chunk(self, idx: torch.Tensor) -> None:
        """The next chunk's batch positions, (rounds, steps, N, B)."""
        self._chunk = idx

    def round(self, r: int, i: int) -> None:
        """Round ``r``, the chunk's ``i``-th."""
        self.idx.copy_(self._chunk[i])
        self.r.fill_(r)
        if self.local is None:
            if self.stream is not None:
                with span("piece.eager", piece="warm_up"):
                    self._warm_up()
            self.local = self._stage(self._local_steps, piece="local")
        self.local()
        if not self.program.gossip_mask[r]:
            return
        t = int(self.program.period_idx[r])
        if t not in self.mix:
            self.mix[t] = self._stage(lambda: self._mix(t), piece="mix", slot=t)
        self.mix[t]()


class _Shard:
    """One shard's part of a sharded ``run_fused`` call, all on its device:
    its (blk, ...) slabs of the params, momentum and CHOCO reference, the
    pre-round snapshots and straggler ring of a faulted run, its nodes'
    data, its batch positions ``idx`` (steps, blk, B), the round ``r``, and
    the static buffers of its half of the mix: ``cat`` (blk, P) its params
    (the reference under CHOCO) side by side, ``pcat`` its published
    snapshots (stragglers only), ``sends`` the rows it sends at each ring
    distance and ``recv`` what it receives (the node axis under the
    allgather)."""

    def __init__(self, s: int, dev: torch.device, run: "_ShardedFusedRounds", steps: int,
                 params: PyTree, momentum: PyTree, cref: PyTree | None):
        tr, prog = run.trainer, run.program
        self.s, self.dev = s, dev
        self.params, self.momentum, self.cref = params, momentum, cref
        self.data = run.data[s]
        blk = run.blk
        self.idx = torch.zeros((steps, blk, tr.loader.batch), dtype=torch.int64, device=dev)
        self.r = torch.zeros((), dtype=torch.int64, device=dev)
        self.p_in = self.o_in = self.hist = self.pcat = None
        self.faults = prog.sh_faults[s] if prog.faulted else None
        if prog.faulted:
            self.p_in = tree_map(torch.empty_like, self.params)
            self.o_in = tree_map(torch.empty_like, self.momentum)
            if prog.delay_max > 0:
                self.hist = faults_mod.init_history(self.params, prog.delay_max + 1)
        mixed = self.params if self.cref is None else self.cref
        width = sum(leaf[0].numel() for leaf in tree_leaves(mixed))
        self.cat = torch.zeros((blk, width), dtype=torch.float32, device=dev)
        if self.hist is not None:
            self.pcat = torch.zeros_like(self.cat)
        view = prog.sh_views[0][s]
        if prog.ring:
            self.sends = [torch.zeros((a.shape[0], width), device=dev) for a in view.ring_send]
            self.recv = [torch.zeros((a.shape[0], width), device=dev) for a in view.ring_recv]
        else:
            self.sends = []
            self.recv = [torch.zeros((tr.num_nodes, width), device=dev)]
        self.graphs: dict[Any, Staged | None] = {}

    @property
    def src(self) -> torch.Tensor:
        """The slab the halo moves: the published snapshots, else ``cat``."""
        return self.cat if self.pcat is None else self.pcat

    def outgoing(self) -> list[torch.Tensor]:
        """This shard's part of the exchange (``MixingProgram.exchange``)."""
        return self.sends if self.sends else [self.src]


class _ShardedFusedRounds:
    """The rounds of one ``run_fused`` call on ``sparse_sharded``, with the
    node state sharded end to end (the reference's ``_scan_rounds_sharded``).

    Each shard (``_Shard``) holds its nodes' slabs on its own device from
    the first round to the last (``core.mesh.scatter``). A round is, shard
    by shard, its local steps over its own slab and batch positions; then,
    on gossip rounds, shard by shard its half of the mix up to the halo's
    sends (``MixingProgram.local_sends``); the halo exchange
    (``MixingProgram.exchange``: ``core.mesh``'s collectives, the round's
    only traffic between shards), copied into the receivers' static
    buffers; and shard by shard its mixed rows written back into its slabs
    (``MixingProgram.local_rows``).

    On the card each shard's piece runs eagerly on its device's capture
    stream the first time (the lazy initialisation a warm-up would do), is
    captured as a CUDA graph on that device the second time and replayed
    after: one capture stream and one graph pool a device. The exchange
    stays eager between the graphs. Replays and the exchange's copies go on
    each device's current stream, and a copy between two cards orders
    itself against both cards' current streams, so nothing else is needed
    to order them; the host launches the shards' work one after another
    without waiting, so on distinct cards it runs at the same time. The
    trainer's params, momentum and CHOCO reference are gathered back on
    its device once, when the call's rounds are done (``gather``).
    """

    def __init__(self, trainer: DecentralizedTrainer, program: decavg.MixingProgram, steps: int):
        self.trainer = trainer
        self.program = program
        self.steps = steps
        self.devices = program.shard_devices
        self.blk = trainer.num_nodes // len(self.devices)
        self.data = trainer.loader.shard_data(self.devices)
        params = _scatter_tree(trainer.params, self.devices)
        momentum = _scatter_tree(trainer.momentum, self.devices)
        crefs = ([None] * len(self.devices) if trainer.cstate is None
                 else _scatter_tree(trainer.cstate.reference, self.devices))
        self.shards = [_Shard(s, d, self, steps, params[s], momentum[s], crefs[s])
                       for s, d in enumerate(self.devices)]
        cards = dict.fromkeys(d for d in self.devices if d.type == "cuda")
        self.streams = {d: torch.cuda.Stream(d) for d in cards}
        self.pools = {d: torch.cuda.graph_pool_handle() for d in cards}
        self._chunk: list[torch.Tensor] = []

    def param_slabs(self) -> list[PyTree]:
        return [sh.params for sh in self.shards]

    def chunk(self, idx: torch.Tensor) -> None:
        """The next chunk's batch positions (rounds, steps, N, B), drawn on
        the trainer's device: each shard's nodes' columns copied to it."""
        b = self.blk
        self._chunk = [idx[:, :, s * b:(s + 1) * b].to(sh.dev) for s, sh in enumerate(self.shards)]

    def _local(self, sh: _Shard) -> None:
        tr = self.trainer
        if self.program.faulted:
            _copy_into(sh.p_in, sh.params)
            _copy_into(sh.o_in, sh.momentum)
        for k in range(self.steps):
            x, y = sh.data.batch_at(sh.idx[k])
            tr._sgd_step(sh.params, sh.momentum, x, y)
        if self.program.faulted:
            with torch.no_grad():
                alive = decavg._row(sh.faults.alive, sh.r)
                _copy_into(sh.params, faults_mod.where_alive(alive, sh.params, sh.p_in))
                _copy_into(sh.momentum, faults_mod.where_alive(alive, sh.momentum, sh.o_in))
                if sh.hist is not None:
                    faults_mod.push(sh.params, sh.hist, sh.r)

    @torch.no_grad()
    def _send(self, sh: _Shard, t: int) -> None:
        tr = self.trainer
        if sh.cref is not None:
            _, state = compress_mod.compress(sh.params, compress_mod.CompressState(sh.cref),
                                             k_frac=tr.compress)
            _copy_into(sh.cref, state.reference)
        sh.cat.copy_(decavg._cat_leaves(sh.params if sh.cref is None else sh.cref))
        if sh.pcat is not None:
            sh.pcat.copy_(decavg._cat_leaves(faults_mod.publish(sh.hist, sh.r, sh.faults.delay)))
        for buf, rows in zip(sh.sends, self.program.local_sends(t, sh.s, sh.src)):
            buf.copy_(rows)

    def _exchange(self, t: int) -> None:
        with span("sharded.exchange", slot=t):
            got = self.program.exchange(t, [sh.outgoing() for sh in self.shards])
            for sh, rows in zip(self.shards, got):
                for buf, x in zip(sh.recv, rows):
                    buf.copy_(x)

    @torch.no_grad()
    def _rows(self, sh: _Shard, t: int) -> None:
        out = self.program.local_rows(t, sh.s, sh.src, sh.recv, r=sh.r, cur=sh.cat,
                                      stale=sh.pcat is not None)
        if sh.cref is None:
            _copy_into(sh.params, decavg._split_leaves(out, sh.params))
            return
        mixed = decavg._split_leaves(out, sh.cref)
        for p, m, ref in zip(tree_leaves(sh.params), tree_leaves(mixed), tree_leaves(sh.cref)):
            p.copy_((p.float() + (m - ref)).to(p.dtype))

    def _run(self, sh: _Shard, key, fn: Callable[[], None]) -> None:
        _run_piece(sh.graphs, key, fn, sh.dev, self.streams.get(sh.dev), self.pools.get(sh.dev),
                   shard=sh.s)

    def round(self, r: int, i: int) -> None:
        """Round ``r``, the chunk's ``i``-th."""
        for sh, idx in zip(self.shards, self._chunk):
            sh.idx.copy_(idx[i])
            sh.r.fill_(r)
        for sh in self.shards:
            self._run(sh, "local", lambda sh=sh: self._local(sh))
        if not self.program.gossip_mask[r]:
            return
        t = int(self.program.period_idx[r])
        for sh in self.shards:
            self._run(sh, ("send", t), lambda sh=sh: self._send(sh, t))
        self._exchange(t)
        for sh in self.shards:
            self._run(sh, ("rows", t), lambda sh=sh: self._rows(sh, t))

    def gather(self) -> None:
        """The shards' state back into the trainer's tensors, in node order."""
        tr, home = self.trainer, self.trainer.device
        pairs = [(tr.params, [sh.params for sh in self.shards]),
                 (tr.momentum, [sh.momentum for sh in self.shards])]
        if tr.cstate is not None:
            pairs.append((tr.cstate.reference, [sh.cref for sh in self.shards]))
        for dst, parts in pairs:
            for d, *slabs in zip(tree_leaves(dst), *(tree_leaves(p) for p in parts)):
                d.copy_(mesh_mod.gather(slabs, home))

    def close(self) -> None:
        """Release the graphs now (see ``_FusedRounds.close``)."""
        for sh in self.shards:
            sh.graphs.clear()


def _run_piece(graphs: dict, key, fn: Callable[[], None], device: torch.device,
               stream: torch.cuda.Stream | None, pool, *, free_first: bool = False,
               shard: int | None = None) -> None:
    """Run the piece ``fn`` known as ``key`` on ``device``: eagerly on the
    CPU. On a card, eagerly on the capture ``stream`` the first time (the
    lazy initialisation a warm-up would do: cuBLAS workspaces, autograd,
    the kernels' modules), captured as a CUDA graph in ``pool`` the second
    time, and replayed after; ``graphs`` holds None for a piece that ran
    once, then its graph. Eager and replayed runs launch the same kernels.
    ``free_first`` returns the eager run's transients to the card before
    the capture. Each run is a span labelled with the piece's name and
    period slot (``key``: a name, or a name and a slot) and its ``shard``."""
    attrs = {"piece": key} if isinstance(key, str) else {"piece": key[0], "slot": key[1]}
    if shard is not None:
        attrs["shard"] = shard
    if device.type != "cuda":
        with span("piece.eager", **attrs):
            fn()
        return
    if key not in graphs:
        graphs[key] = None
        with span("piece.eager", **attrs), torch.cuda.device(device):
            current = torch.cuda.current_stream(device)
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                fn()
            current.wait_stream(stream)
        return
    if graphs[key] is None:
        if free_first:
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
        graphs[key] = Staged(fn, device, stream=stream, pool=pool, attrs=attrs)
    graphs[key]()


def _copy_into(dst: PyTree, src: PyTree) -> None:
    """Copy ``src``'s leaves into ``dst``'s tensors (static buffers)."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        d.copy_(s)


def _map_state(fn: Callable[..., torch.Tensor], tree: PyTree, *rest: PyTree) -> PyTree:
    """``tree_map`` that keeps a NamedTuple at the top (an optimizer or
    compression state) as its own type."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    return tree_map(fn, tree, *rest)


def _scatter_tree(tree: PyTree, devices: list[torch.device]) -> list[PyTree]:
    """A node-stacked tree as one tree of slabs a shard (``core.mesh.scatter``),
    each a copy on its shard's device; a 0-dim leaf (AdamW's shared step
    count) is copied to every shard."""
    per_leaf = [[x.to(d, copy=True) for d in devices] if x.dim() == 0
                else mesh_mod.scatter(x, devices) for x in tree_leaves(tree)]
    out = []
    for s in range(len(devices)):
        it = iter([p[s] for p in per_leaf])
        out.append(_map_state(lambda _, it=it: next(it), tree))
    return out


def _gather_tree(parts: list[PyTree], device: torch.device) -> PyTree:
    """Per-shard trees back as one node-stacked tree on ``device``, leaf by
    leaf in shard order (``core.mesh.gather``); a 0-dim leaf is shard 0's."""
    return _map_state(lambda *xs: (xs[0].to(device, copy=True) if xs[0].dim() == 0
                                   else mesh_mod.gather(list(xs), device)), *parts)


# ---------------------------------------------------------------------------
# LLM cohorts (model kind "lm"; experiments/runner.py dispatches here)
# ---------------------------------------------------------------------------

# Backends run_fused supports for LM cohorts, as in the reference.
_LM_FUSED_BACKENDS = ("dense", "sparse", "sparse_pallas")

# compress="auto" threshold: members whose parameter tree exceeds this many
# bytes gossip through CHOCO top-k by default (a reduced 1B-class member is
# ~6 MB in f32, the tiny test transformers ~100 KB).
_COMPRESS_AUTO_BYTES = 1 << 20
_COMPRESS_AUTO_K = 0.1


class LMCohortTrainer:
    """DecAvg over a cohort of transformer LMs on domain-skewed token streams.

    The LM analogue of ``DecentralizedTrainer``: node-stacked transformer
    params broadcast from one member's init (drawn from ``seed`` on the
    trainer's device), per-round next-token training (AdamW or SGD under an
    LR schedule) and gossip through one ``GossipEngine``. Token batches are
    a pure function of ``(seed, node, round)`` (data/tokens.py), so both run
    paths draw the same data:

    - ``run``: one Python iteration per round, launched eagerly.
    - ``run_fused``: the engine's ``MixingProgram`` staged up front, and on
      the card each round's local step and each period slot's gossip as a
      CUDA graph, captured once and replayed. The round, the token batch,
      the schedule's LR (computed from the round on the device), AdamW's
      step count and the fault masks are device buffers the graphs read.
      Same seed gives the same params and loss as ``run``.

    A local step sums every node's loss over views of the stacked leaves and
    takes one ``torch.autograd.grad``: no term couples two nodes, so each
    node gets its own gradient exactly. Updates (optimizer, gossip, fault
    freezes, CHOCO) are in place and leaf by leaf, so a full-width member
    never needs a second copy of the tree.

    On ``sparse_sharded`` the cohort's state is sharded, as the reference
    keeps it: the params, the optimizer state (AdamW's moments, its shared
    step count replicated on each shard; SGD's momentum), CHOCO's references
    and the straggler ring are per-shard slabs, shard s's nodes
    ``[s N/S, (s+1) N/S)`` on the s-th device of the engine's mesh (default:
    one shard per card), from construction on and across ``run`` calls. Each
    shard's local step, dead-node freezes, CHOCO top-k (per node row, so
    exact per shard) and metrics run on its own device, and the halo
    exchange of the mix (``GossipEngine.mix_slabs``, leaf by leaf, so the
    transient halo is one leaf's) is the only traffic between shards. It
    gives ``sparse``'s bits. ``params``, ``opt_state`` and ``cstate`` read
    as the global trees, gathered to the trainer's device (a copy), and
    assigning one scatters it; nothing on the path of ``run``, the metrics
    or the checkpoint reads them whole. ``run_fused`` does not stage
    ``sparse_sharded``, as in the reference. Every other backend keeps the
    cohort on the trainer's device.

    ``compress="auto"`` turns on CHOCO top-k gossip when a member exceeds
    ~1 MB; a float is an explicit k fraction and ``None`` forces raw DecAvg.
    Faults never compose with compression: "auto" resolves to off under
    faults, an explicit fraction raises. With ``faults=`` dead nodes keep
    their params and both optimizer moments bit-exactly (AdamW's shared step
    count advances). Checkpoints save ``(params, opt[, cstate])`` plus the
    step, and ``restore`` resumes bit-identically (a sharded trainer's go
    leaf by leaf through the host, and either kind restores the other's).
    As in the reference, ``cfg.opt_dtype`` is not read: the moments are
    f32. ``mesh`` is the engine's, for the mesh backends (without one,
    sparse_sharded takes the engine's default mesh). An enc-dec member is
    refused: the cohort's batches are tokens only, with no encoder frames
    (the reference's cohort stops at ``KeyError: 'frames'``).
    """

    def __init__(
        self,
        topology: Graph | TopologySchedule | str,
        cfg,
        *,
        nodes: int,
        batch: int = 4,
        seq: int = 128,
        lr: float = 3e-4,
        schedule: str = "cosine",
        backend: str = "auto",
        matrix: str = "decavg",
        gossip_every: int = 1,
        compress: float | str | None = "auto",
        faults: str | None = None,
        seed: int = 0,
        data_kwargs: dict | None = None,
        mesh: mesh_mod.Mesh | None = None,
        device: str | torch.device | None = None,
    ):
        if cfg.enc_dec:
            raise ValueError(f"{cfg.arch_id} is an encoder-decoder: an LM cohort's batches "
                             "carry tokens only, no encoder frames")
        self.cfg = cfg
        self.num_nodes = int(nodes)
        self.batch, self.seq = int(batch), int(seq)
        self.lr, self.schedule_name, self.seed = lr, schedule, seed
        self.data_kwargs = dict(data_kwargs or {})
        self.engine = decavg.GossipEngine(
            topology, backend=backend, matrix=matrix, gossip_every=gossip_every,
            faults=faults, seed=seed, mesh=mesh, n=self.num_nodes, device=device,
        )
        if self.engine.num_nodes != self.num_nodes:
            raise ValueError(
                f"topology spec pins n={self.engine.num_nodes} but nodes is {self.num_nodes}"
            )
        self.device = self.engine.device
        self.mix_impl = self.engine.backend
        self.faulted = self.engine.faults is not None
        self._has_hist = self.faulted and self.engine.fault_trace.delay_max > 0
        self.sharded = self.mix_impl == "sparse_sharded"
        self._devs = self._shard_devices()

        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        per_node = TF.init_params(gen, cfg, device=self.device)
        self.member_params = TF.param_count(per_node)
        self.member_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(per_node))
        self.compress = self._resolve_compress(compress)
        # The one draw copied to each shard's device and broadcast over its
        # nodes (all N on the trainer's device when unsharded), into tensors
        # of their own: an expanded view of one node is already contiguous.
        blk = self.num_nodes // len(self._devs)
        self._p = [tree_map(lambda x, d=d: x.new_empty((blk, *x.shape), device=d).copy_(x.to(d)),
                            per_node)
                   for d in self._devs]
        del per_node
        self.use_adamw = cfg.optimizer == "adamw"
        self._o = [adamw.init(p) if self.use_adamw else sgd.init(p).momentum for p in self._p]
        self._c = None if self.compress is None else [compress_mod.init(p) for p in self._p]
        self._hist: list[PyTree] | None = None  # a sharded loop's straggler rings
        self.start_round = 0  # advanced by restore()
        self._loss_fn = ST.node_loss_fn(cfg)
        self._sched = None  # built per run (total_steps = that run's rounds)
        self._eval_data = None
        # (N,) the last round's per-node losses, on the trainer's device.
        self.node_losses: torch.Tensor | None = None

    @property
    def graph(self):
        return self.engine.graph

    @property
    def supports_fused(self) -> bool:
        """True when ``run_fused`` can execute this trainer's backend."""
        return self.mix_impl in _LM_FUSED_BACKENDS

    @property
    def shards(self) -> int:
        """How many shards hold the cohort's state (1 unless sharded)."""
        return len(self._devs)

    def shard_state_bytes(self) -> list[int]:
        """Bytes of each shard's state: its params, optimizer state, CHOCO
        references and straggler ring."""
        parts = [self._p, self._o] + [x for x in (self._c, self._hist) if x is not None]
        return [sum(x.numel() * x.element_size() for t in trees for x in tree_leaves(t))
                for trees in zip(*parts)]

    def _shard_devices(self) -> list[torch.device]:
        return self.engine.shard_devices if self.sharded else [self.device]

    def _resolve_compress(self, compress) -> float | None:
        if compress == "auto":
            if self.faulted or self.member_bytes <= _COMPRESS_AUTO_BYTES:
                return None
            return _COMPRESS_AUTO_K
        if compress is None or compress is False:
            return None
        k = float(compress)
        if not 0.0 < k <= 1.0:
            raise ValueError(f"compress (top-k fraction) must be in (0, 1], got {compress}")
        if self.faulted:
            raise ValueError(
                "faults do not compose with compress= gossip: the CHOCO "
                "reference update assumes every published model is current"
            )
        return k

    # -- the state: one tree a shard (one in all when unsharded) --------------

    def _whole(self, parts: list[PyTree]) -> PyTree:
        return parts[0] if not self.sharded else _gather_tree(parts, self.device)

    def _place(self, tree: PyTree) -> list[PyTree]:
        return [tree] if not self.sharded else _scatter_tree(tree, self._devs)

    @property
    def params(self) -> PyTree:
        """The node-stacked params; sharded, the shards' slabs gathered to
        the trainer's device (a copy). Assigning a global tree scatters it."""
        return self._whole(self._p)

    @params.setter
    def params(self, tree: PyTree) -> None:
        self._p = self._place(tree)

    @property
    def opt_state(self) -> PyTree:
        """AdamW's state or SGD's momentum, as ``params``."""
        return self._whole(self._o)

    @opt_state.setter
    def opt_state(self, state: PyTree) -> None:
        self._o = self._place(state)

    @property
    def cstate(self) -> compress_mod.CompressState | None:
        """CHOCO's references (None without compression), as ``params``."""
        return None if self._c is None else self._whole(self._c)

    @cstate.setter
    def cstate(self, state: compress_mod.CompressState | None) -> None:
        self._c = None if state is None else self._place(state)

    def _follow_mesh(self) -> None:
        """Re-place a sharded state whose mesh was replaced since
        (``engine.mesh = ...``): each tree gathered to the host and
        scattered to the new shards' devices, never onto one card."""
        devs = self._shard_devices()
        if devs == self._devs:
            return
        cpu = torch.device("cpu")
        trees = [_gather_tree(parts, cpu) if parts is not None else None
                 for parts in (self._p, self._o, self._c, self._hist)]
        self._devs = devs
        self._p, self._o, self._c, self._hist = (
            None if t is None else self._place(t) for t in trees)
        self._eval_data = None

    def _rows(self, a, s: int):
        """Shard ``s``'s rows of a node-indexed array (all of them unsharded)."""
        blk = self.num_nodes // len(self._devs)
        return a[s * blk:(s + 1) * blk]

    def _split(self, toks: np.ndarray, labels: np.ndarray) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """(N, ...) host token arrays cut on the host into each shard's rows
        on its device."""
        return [(torch.as_tensor(self._rows(toks, s), device=d),
                 torch.as_tensor(self._rows(labels, s), device=d))
                for s, d in enumerate(self._devs)]

    def _mean(self, losses: list[torch.Tensor]) -> torch.Tensor:
        """The cohort's mean of the shards' per-node values, in node order on
        the trainer's device."""
        return mesh_mod.gather(losses, self.device).mean()

    # -- the round's pieces (in place on one shard's state) -------------------

    def _per_node(self, params: PyTree, toks: torch.Tensor, labels: torch.Tensor,
                  fn) -> torch.Tensor:
        """(n,) values of ``fn(params[i], batch i)``, node ``i`` on its own
        (unstacked) params and its batch."""
        return torch.stack([
            fn(tree_map(lambda x, i=i: x[i], params),
               {"tokens": toks[i], "labels": labels[i]})
            for i in range(toks.shape[0])
        ])

    def _local_step(self, params: PyTree, opt: PyTree, toks: torch.Tensor,
                    labels: torch.Tensor, lr) -> torch.Tensor:
        """One optimizer step on every node of ``params`` (a shard's nodes,
        or the cohort's) and its optimizer state ``opt``, in place; returns
        their (n,) losses."""
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            losses = self._per_node(tree_unflatten(params, leaves), toks, labels,
                                    self._loss_fn)
            grads = torch.autograd.grad(losses.sum(), leaves)
        del leaves
        if self.use_adamw:
            adamw.update_(list(grads), opt, params, lr=lr)
        else:
            sgd.update_(list(grads), opt, params, lr=lr, mu=0.5)
        return losses.detach()

    def _local_steps(self, batch: list[tuple[torch.Tensor, torch.Tensor]],
                     lr: torch.Tensor) -> list[torch.Tensor]:
        """Each shard's local step on its own device; their (blk,) losses."""
        return [self._local_step(p, o, toks, labels, lr.to(d))
                for p, o, (toks, labels), d in zip(self._p, self._o, batch, self._devs)]

    @torch.no_grad()
    def _freeze_dead(self, params: PyTree, opt: PyTree, alive: torch.Tensor,
                     p_in: list[torch.Tensor], o_in: list[torch.Tensor]) -> None:
        """Dead nodes back to their pre-round params and moments (the
        reference's ``where_alive`` / ``where_alive_stacked``): ``alive`` is
        the nodes' of ``params``, ``p_in`` and ``o_in`` their leaves before
        the step, in ``tree_leaves`` order; shared leaves (AdamW's count)
        pass through."""
        n = alive.shape[0]
        for new, old in zip(tree_leaves(params) + tree_leaves(opt), p_in + o_in):
            if new.dim() and new.shape[0] == n:
                new.copy_(torch.where(faults_mod._node_mask(alive, new), new, old))

    @torch.no_grad()
    def _gossip(self, mix: Callable[[list[torch.Tensor]], list[torch.Tensor]]) -> None:
        """One gossip exchange, leaf by leaf, through ``mix`` (one leaf's
        per-shard slabs -> its mixed slabs; unsharded, a list of one).
        Without compression: DecAvg. With it, CHOCO: each node publishes the
        top-k of ``params - reference`` (the reference advances by it),
        peers mix the references, and each node keeps its residual,
        ``params + W @ ref - ref``."""
        per_shard = [tree_leaves(p) for p in self._p]
        if self.compress is None:
            for leaves in zip(*per_shard):
                for p, m in zip(leaves, mix(list(leaves))):
                    p.copy_(m)
            return
        refs = [tree_leaves(c.reference) for c in self._c]
        for leaves, shard_refs in zip(zip(*per_shard), zip(*refs)):
            for p, ref in zip(leaves, shard_refs):
                _, state = compress_mod.compress([p], compress_mod.CompressState([ref]),
                                                 k_frac=self.compress)
                ref.copy_(state.reference[0])
                del state
            for p, m, ref in zip(leaves, mix(list(shard_refs)), shard_refs):
                p.copy_((p.float() + (m - ref)).to(p.dtype))

    def _mix_leaf(self, slabs: list[torch.Tensor]) -> list[torch.Tensor]:
        """The loop's mix of one leaf: sharded, of its slabs where they
        live; else the engine's mix of the node-stacked leaf."""
        if self.sharded:
            return self.engine.mix_slabs(slabs)
        return [self.engine.mix([slabs[0]])[0]]

    def _faulted_round(self, r: int, batch, lr: torch.Tensor) -> list[torch.Tensor]:
        """One faulted round of the loop: each shard trains and puts its
        dead nodes back, then the renormalized faulted mix and the straggler
        ring (the engine's, one call per round in order; the trainer's own
        per-shard rings when sharded)."""
        alive = self.engine.fault_trace.alive(r)
        losses = []
        for s, (p, o, (toks, labels), d) in enumerate(zip(self._p, self._o, batch, self._devs)):
            p_in = [x.clone() for x in tree_leaves(p)]
            o_in = [x.clone() for x in tree_leaves(o)]
            losses.append(self._local_step(p, o, toks, labels, lr.to(d)))
            self._freeze_dead(p, o, torch.as_tensor(self._rows(alive, s), device=d), p_in, o_in)
            del p_in, o_in
        with torch.no_grad():
            if self.sharded:
                self._mix_faulted_slabs(r)
            else:
                _copy_into(self._p[0], self.engine.mix(self._p[0], round=r))
        return losses

    @torch.no_grad()
    def _mix_faulted_slabs(self, r: int) -> None:
        """``engine.mix(params, round=r)`` of a faulted engine on the
        shards' slabs: each shard's straggler ring pushed every round, and
        on gossip rounds each leaf's renormalized mix of the published
        snapshots."""
        eng = self.engine
        eng.refresh(r)
        trace = eng.fault_trace
        pub = None
        if trace.delay_max > 0:
            if self._hist is None:
                self._hist = [faults_mod.init_history(p, trace.delay_max + 1) for p in self._p]
            pub = [tree_leaves(faults_mod.push_and_publish(
                       p, h, r, torch.as_tensor(self._rows(trace.delay, s), device=d))[0])
                   for s, (p, h, d) in enumerate(zip(self._p, self._hist, self._devs))]
        if not eng.is_gossip_round(r):
            return
        masks = eng.shard_masks(r)
        for j, leaves in enumerate(zip(*(tree_leaves(p) for p in self._p))):
            mixed = eng.mix_slabs(list(leaves), masks=masks,
                                  pub=None if pub is None else [q[j] for q in pub])
            for p, m in zip(leaves, mixed):
                p.copy_(m)

    # -- metrics / checkpoint -------------------------------------------------

    @torch.no_grad()
    def consensus(self) -> np.ndarray:
        """(N,) distances to the node mean, its sums taken node by node in
        node order, so a sharded cohort gives the unsharded bits."""
        return sharded_consensus_distance(self._p, self.device,
                                          in_node_order=True).cpu().numpy()

    @torch.no_grad()
    def _domain_eval(self, params: PyTree, toks: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
        """(n,) per-node mean true-token probability on the held-out
        foreign-domain eval batch (``domain_acc``)."""

        def node_eval(p, batch):
            logits, _ = TF.forward(p, self.cfg, batch["tokens"], remat=False)
            logp = torch.log_softmax(logits.float(), dim=-1)
            ll = logp.gather(-1, batch["labels"].long().unsqueeze(-1)).squeeze(-1)
            return torch.exp(ll).mean()

        return self._per_node(params, toks, labels, node_eval)

    def domain_metrics(self) -> dict:
        """G2-style knowledge-spread metrics on the token task: per-node
        ``domain_acc`` on *other* nodes' domain tokens, and their cohort mean
        ``g2_token_spread`` (the store/analysis join key). Each shard's
        members are evaluated on its device."""
        if self.num_nodes < 2:
            return {}
        from repro_torch.data import tokens as tok

        if self._eval_data is None:
            self._eval_data = self._split(*tok.domain_eval_batch(
                self.num_nodes, self.batch, self.seq, self.cfg.vocab_size, seed=self.seed,
                **{k: v for k, v in self.data_kwargs.items() if k == "domain_size"},
            ))
        accs = mesh_mod.gather([self._domain_eval(p, toks, labels) for p, (toks, labels)
                                in zip(self._p, self._eval_data)], self.device).cpu().numpy()
        return {
            "domain_acc": [round(float(a), 6) for a in accs],
            "g2_token_spread": float(accs.mean()),
        }

    def _state_trees(self) -> dict[str, list[PyTree]]:
        trees = {"params": self._p, "opt": self._o}
        if self._c is not None:
            trees["cstate"] = self._c
        return trees

    def save(self, path: str, *, step: int) -> None:
        """Checkpoint ``(params, opt[, cstate])`` plus the step: everything a
        bit-identical resume needs (the reference's npz layout). A sharded
        state is gathered leaf by leaf to the host, never onto one card."""
        from repro_torch.checkpoint import ckpt

        cpu = torch.device("cpu")
        ckpt.save(path, {k: _gather_tree(v, cpu) if self.sharded else v[0]
                         for k, v in self._state_trees().items()}, step=step)

    def restore(self, path: str) -> int:
        """Restore a ``save`` checkpoint; the next ``run``/``run_fused``
        continues from the round after the saved step, re-deriving the same
        batches and LR the uninterrupted run would have seen. A sharded
        trainer reads each leaf to the host and scatters it; checkpoints of
        either kind restore into either."""
        from repro_torch.checkpoint import ckpt

        if self._has_hist:
            raise ValueError(
                "resume does not compose with straggler faults: the "
                "delayed-snapshot ring buffer is not checkpointed"
            )
        if self.sharded:
            def meta(x: torch.Tensor) -> torch.Tensor:
                shape = (self.num_nodes,) + tuple(x.shape[1:]) if x.dim() else ()
                return torch.empty(shape, dtype=x.dtype, device="meta")

            like = {k: _map_state(meta, v[0]) for k, v in self._state_trees().items()}
            tree, step = ckpt.restore(path, like, device="cpu")
        else:
            tree, step = ckpt.restore(path, {k: v[0] for k, v in self._state_trees().items()})
        if step is None:
            raise ValueError(f"checkpoint {path!r} carries no step")
        self.params, self.opt_state = tree["params"], tree["opt"]
        if self._c is not None:
            self.cstate = tree["cstate"]
        self.start_round = int(step) + 1
        return self.start_round

    @staticmethod
    def _ckpt_rounds(rounds: int, ckpt_every: int) -> set[int]:
        """Checkpoint cadence: every ``ckpt_every`` rounds and the final round."""
        if not ckpt_every:
            return set()
        s = {r for r in range(1, rounds) if r % ckpt_every == 0}
        s.add(rounds - 1)
        return s

    def _batch(self, r: int) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """Round ``r``'s tokens and labels, each shard's rows on its device."""
        from repro_torch.data import tokens as tok

        return self._split(*tok.round_token_batch(
            self.num_nodes, r, self.batch, self.seq, self.cfg.vocab_size,
            seed=self.seed, **self.data_kwargs,
        ))

    def _round_record(self, r: int, loss, lr, t0: float) -> dict:
        rec = {
            "round": r,
            "loss": float(loss),
            "lr": float(lr),
            "wall_s": round(time.perf_counter() - t0, 4),
            **self.domain_metrics(),
        }
        if self.faulted:
            rec["alive_count"] = int(self.engine.fault_trace.alive(r).sum())
        return rec

    def _emit(self, rec: dict, on_round, verbose: bool, note: str = "") -> None:
        if on_round is not None:
            on_round(rec)
        if verbose:
            print(f"step {rec['round']:4d}  loss {rec['loss']:.4f}  lr {rec['lr']:.2e}  "
                  + (note or f"({rec['wall_s']:.0f}s)"))

    @torch.no_grad()
    def _finished_resume(self, rounds: int, on_round, verbose: bool, t0: float) -> list[dict]:
        """A resume that restored the final checkpoint has nothing left to
        train; it still emits one record at the restored state, so the run's
        final record exists."""
        loss = self._mean([self._per_node(p, toks, labels, self._loss_fn)
                           for p, (toks, labels) in zip(self._p, self._batch(rounds - 1))])
        rec = self._round_record(rounds - 1, loss, self._sched(rounds - 1), t0)
        self._emit(rec, on_round, verbose, "(resume already complete)")
        return [rec]

    @staticmethod
    def _evals(rounds: int, eval_every: int | None) -> set[int]:
        """The rounds both run paths record (evaluate and stream): ``run``'s
        cadence, or none for ``eval_every=None``."""
        if eval_every is None:
            return set()
        return set(DecentralizedTrainer._eval_rounds(rounds, eval_every))

    def _begin(self, rounds: int) -> bool:
        """Per-run set-up; True when a restored run has nothing left."""
        self._sched = schedules.get(self.schedule_name, self.lr, rounds)
        return self.start_round >= rounds

    # -- run paths --------------------------------------------------------------

    def run(
        self,
        rounds: int,
        *,
        eval_every: int | None = 1,
        on_round: Callable[[dict], None] | None = None,
        ckpt_every: int = 0,
        ckpt_path: str = "",
        verbose: bool = False,
    ) -> list[dict]:
        """Per-round Python loop: the local step and the engine's mix,
        eagerly; sharded, each shard's step on its device and the mix of
        its slabs. Every ``eval_every`` rounds and at the last, the round's
        record (the cohort's domain evaluation) goes to ``on_round`` and
        the returned history; ``eval_every=None`` records nothing."""
        _check_mesh(self.engine, self.device)
        self._follow_mesh()
        t0 = time.perf_counter()
        if self._begin(rounds):
            return self._finished_resume(rounds, on_round, verbose, t0)
        evals = self._evals(rounds, eval_every)
        cpts = self._ckpt_rounds(rounds, ckpt_every)
        if self.faulted:
            self.engine.fault_trace.ensure(rounds)
        history: list[dict] = []
        for r in range(self.start_round, rounds):
            batch = self._batch(r)
            lr = self._sched(r).to(self.device)
            if self.faulted:
                losses = self._faulted_round(r, batch, lr)
            else:
                losses = self._local_steps(batch, lr)
                if self.engine.is_gossip_round(r):
                    self.engine.refresh(r)
                    self._gossip(self._mix_leaf)
            self.node_losses = mesh_mod.gather(losses, self.device)
            if r in evals:
                rec = self._round_record(r, self._mean(losses), lr, t0)
                history.append(rec)
                self._emit(rec, on_round, verbose)
            if r in cpts:
                self.save(ckpt_path, step=r)
        return history

    def run_fused(
        self,
        rounds: int,
        *,
        eval_every: int | None = 1,
        on_round: Callable[[dict], None] | None = None,
        ckpt_every: int = 0,
        ckpt_path: str = "",
        verbose: bool = False,
    ) -> list[dict]:
        """``run`` from a staged program; on the card, captured CUDA graphs.

        Rounds go in chunks that end at the eval and checkpoint rounds (so
        checkpoints land on exact round boundaries); with nothing to record
        (``eval_every=None``) and no checkpoint, the run is one chunk. A
        chunk's token slab is drawn on the host for just its rounds and
        copied to the device; each round refills the static batch and round
        buffers and replays the local-step graph and, on gossip rounds, its
        period slot's gossip graph. Supported for the dense, sparse and sparse_pallas backends.
        Building the program, staging and releasing the graphs are spans
        (``fused.program``, ``fused.stage``, ``fused.close``), as each
        piece's eager run, capture and replay are.
        """
        if not self.supports_fused:
            raise ValueError(
                f"run_fused supports backends {_LM_FUSED_BACKENDS}, not "
                f"{self.mix_impl!r}; use run()"
            )
        from repro_torch.data import tokens as tok

        t0 = time.perf_counter()
        if self._begin(rounds):
            return self._finished_resume(rounds, on_round, verbose, t0)
        with span("fused.program"):
            program = self.engine.program(rounds, kind=self.mix_impl)
        evals = self._evals(rounds, eval_every)
        cpts = self._ckpt_rounds(rounds, ckpt_every)
        with span("fused.stage"):
            staged = _LMFusedRounds(self, program)
        history: list[dict] = []
        prev = self.start_round - 1
        try:
            for end in sorted(evals | cpts | {rounds - 1}):
                if end < self.start_round:
                    continue
                start, prev = prev + 1, end
                toks, labels = tok.round_token_slab(
                    self.num_nodes, range(start, end + 1), self.batch, self.seq,
                    self.cfg.vocab_size, seed=self.seed, **self.data_kwargs,
                )
                toks = torch.as_tensor(toks, device=self.device)
                labels = torch.as_tensor(labels, device=self.device)
                for i, r in enumerate(range(start, end + 1)):
                    staged.round(r, toks[i], labels[i])
                if end in evals:
                    rec = self._round_record(end, staged.loss, self._sched(end), t0)
                    history.append(rec)
                    self._emit(rec, on_round, verbose)
                if end in cpts:
                    self.save(ckpt_path, step=end)
        finally:
            with span("fused.close"):
                staged.close()
        return history


class _LMFusedRounds:
    """The rounds of one ``LMCohortTrainer.run_fused`` call.

    Static buffers: the trainer's params, optimizer state and compression
    reference (updated in place), the round's token batch ``toks``/``labels``
    and the round ``r`` (an int64 0-dim tensor), both refilled before each
    round, and the round's per-node losses (the trainer's ``node_losses``)
    and ``loss``, their mean. The schedule's LR is
    computed from ``r`` on the device. On a faulted program the pieces also
    hold the pre-round snapshots and the straggler ring, and read the
    round's alive and keep rows through ``r``.

    On the card each piece (the local step; the gossip of each period slot)
    runs eagerly on the capture stream the first time it is used, which
    does the lazy initialisation a warm-up would (cuBLAS workspaces,
    autograd, the kernels' modules) on the live state: a full-width member
    has no room for the scratch copies a separate warm-up would need. The
    second use captures it as a CUDA graph; later uses replay it. Eager and
    replayed runs launch the same kernels, so a round gives the same bits
    either way.
    """

    def __init__(self, trainer: LMCohortTrainer, program: decavg.MixingProgram):
        self.trainer = trainer
        self.program = program
        dev = trainer.device
        self.device = dev
        shape = (trainer.num_nodes, trainer.batch, trainer.seq)
        self.toks = torch.zeros(shape, dtype=torch.int32, device=dev)
        self.labels = torch.zeros(shape, dtype=torch.int32, device=dev)
        self.r = torch.zeros((), dtype=torch.int64, device=dev)
        self._loss = torch.zeros((), dtype=torch.float32, device=dev)
        trainer.node_losses = self._losses = torch.zeros(trainer.num_nodes, dtype=torch.float32,
                                                         device=dev)
        self.hist = None
        self.p_in = self.o_in = None
        if program.faulted:
            self.p_in = [torch.empty_like(x) for x in tree_leaves(trainer.params)]
            self.o_in = [torch.empty_like(x) for x in tree_leaves(trainer.opt_state)]
            if program.delay_max > 0:
                self.hist = faults_mod.init_history(trainer.params, program.delay_max + 1)
        self.graphs: dict[Any, Staged | None] = {}
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        # The pieces run one after another on one stream and keep nothing
        # alive between runs, so their graphs can share one memory pool.
        self.pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None

    @property
    def loss(self) -> float:
        return float(self._loss)

    def _local(self) -> None:
        tr = self.trainer
        if self.program.faulted:
            for d, s in zip(self.p_in + self.o_in,
                            tree_leaves(tr.params) + tree_leaves(tr.opt_state)):
                d.copy_(s)
        self._losses.copy_(tr._local_step(tr.params, tr.opt_state, self.toks, self.labels,
                                          tr._sched(self.r)))
        self._loss.copy_(self._losses.mean())
        if self.program.faulted:
            tr._freeze_dead(tr.params, tr.opt_state, self.program.alive_at(self.r),
                            self.p_in, self.o_in)
            if self.hist is not None:
                with torch.no_grad():
                    faults_mod.push(tr.params, self.hist, self.r)

    @torch.no_grad()
    def _mix(self, t: int) -> None:
        tr, prog = self.trainer, self.program
        if prog.faulted:
            pub = (None if self.hist is None
                   else faults_mod.publish(self.hist, self.r, prog.f_delay))
            _copy_into(tr.params, prog.apply_period(tr.params, t, r=self.r, pub=pub))
        else:
            tr._gossip(lambda xs: [prog.apply_period([xs[0]], t)[0]])

    def _run(self, key, fn: Callable[[], None]) -> None:
        # A full-width member: the eager run's transients go back to the
        # card before the capture takes its own pool.
        _run_piece(self.graphs, key, fn, self.device, self.stream, self.pool, free_first=True)

    def close(self) -> None:
        """Release the graphs now (see ``_FusedRounds.close``)."""
        self.graphs.clear()

    def round(self, r: int, toks: torch.Tensor, labels: torch.Tensor) -> None:
        self.toks.copy_(toks)
        self.labels.copy_(labels)
        self.r.fill_(r)
        self._run("local", self._local)
        if not self.program.gossip_mask[r]:
            return
        t = int(self.program.period_idx[r])
        self._run(("mix", t), lambda: self._mix(t))
