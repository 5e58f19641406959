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
the engine's ``core.mesh.Mesh``; the local steps stay node-stacked over all
N on the trainer's device (the reference's per-slab steps are the same
arithmetic: no term couples two nodes), so the mesh must sit on that device.

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
from repro_torch.kernels import sparse_gossip
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as TF
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.optim import adamw, schedules, sgd
from repro_torch.train.losses import softmax_xent
from repro_torch.train.metrics import (
    accuracy,
    confusion_matrix,
    consensus_distance,
    group_accuracy,
)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PyTree = Any

__all__ = ["DecentralizedTrainer", "LMCohortTrainer", "RoundMetrics"]

# Backends run_fused supports: those whose per-period operators stack into a
# MixingProgram. Mirrors the ``fused`` flags of GossipEngine.capabilities().
_FUSED_BACKENDS = ("dense", "sparse", "sparse_pallas", "sparse_sharded")


def _own_mesh(mesh: mesh_mod.Mesh | None, backend: str, device) -> mesh_mod.Mesh | None:
    """A trainer's default sparse_sharded mesh: one shard on its own device.
    The engine's default has a shard per local card, which the trainers,
    keeping every node's state on one device, cannot run on a machine with
    several (``_check_mesh``)."""
    if mesh is None and backend == "sparse_sharded":
        return mesh_mod.local_mesh(device=device, shards=1)
    return mesh


def _check_mesh(engine: decavg.GossipEngine, device: torch.device) -> None:
    """The trainers keep every node's state on one device, so a mesh backend
    runs only over a mesh whose shards all sit on that device (it may repeat
    it, to run S > 1 shards there)."""
    if engine.mesh is None or engine.backend not in decavg._MESH_BACKENDS:
        return
    devices = {str(d) for d in engine.mesh.device_set}
    if len(devices) > 1:
        raise NotImplementedError(
            f"a mesh over several devices ({sorted(devices)}) is not supported by "
            "the trainers yet: they keep every node's state on one device"
        )
    if not any(mesh_mod.same_device(d, device) for d in engine.mesh.device_set):
        raise ValueError(f"mesh on {devices.pop()}, trainer on {device}")


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
    both packages from the same weights. ``mesh`` (a ``core.mesh.Mesh`` on
    the trainer's device) is the engine's, for the mesh backends; without
    one, sparse_sharded runs one shard on the trainer's device. ``device``
    is where everything runs; None means CUDA (and raises without a card).
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
            faults=faults, seed=seed, mesh=_own_mesh(mesh, mix_impl, device),
            n=len(loader.sizes), device=device,
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
        ``run``). A capture that fails on the card raises.
        """
        if not self.supports_fused:
            raise ValueError(
                f"run_fused supports backends {_FUSED_BACKENDS}, not "
                f"{self.mix_impl!r}; use run()"
            )
        _check_mesh(self.engine, self.device)
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
                self._enter_period(end)
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

    ``compress="auto"`` turns on CHOCO top-k gossip when a member exceeds
    ~1 MB; a float is an explicit k fraction and ``None`` forces raw DecAvg.
    Faults never compose with compression: "auto" resolves to off under
    faults, an explicit fraction raises. With ``faults=`` dead nodes keep
    their params and both optimizer moments bit-exactly (AdamW's shared step
    count advances). Checkpoints save ``(params, opt[, cstate])`` plus the
    step, and ``restore`` resumes bit-identically. As in the reference,
    ``cfg.opt_dtype`` is not read: the moments are f32. ``mesh`` is the
    engine's, for the mesh backends, which mix in ``run`` only (without one,
    sparse_sharded runs one shard on the trainer's device). An enc-dec
    member is refused: the cohort's batches are tokens only, with no encoder
    frames (the reference's cohort stops at ``KeyError: 'frames'``).
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
            faults=faults, seed=seed, mesh=_own_mesh(mesh, backend, device),
            n=self.num_nodes, device=device,
        )
        if self.engine.num_nodes != self.num_nodes:
            raise ValueError(
                f"topology spec pins n={self.engine.num_nodes} but nodes is {self.num_nodes}"
            )
        self.device = self.engine.device
        self.mix_impl = self.engine.backend
        self.faulted = self.engine.faults is not None
        self._has_hist = self.faulted and self.engine.fault_trace.delay_max > 0

        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        per_node = TF.init_params(gen, cfg, device=self.device)
        self.member_params = TF.param_count(per_node)
        self.member_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(per_node))
        self.compress = self._resolve_compress(compress)
        n = self.num_nodes
        self.params = tree_map(lambda x: x.expand(n, *x.shape).contiguous(), per_node)
        del per_node
        self.use_adamw = cfg.optimizer == "adamw"
        self.opt_state = adamw.init(self.params) if self.use_adamw else sgd.init(self.params).momentum
        self.cstate = None if self.compress is None else compress_mod.init(self.params)
        self.start_round = 0  # advanced by restore()
        self._loss_fn = ST.node_loss_fn(cfg)
        self._sched = None  # built per run (total_steps = that run's rounds)
        self._eval_data = None

    @property
    def graph(self):
        return self.engine.graph

    @property
    def supports_fused(self) -> bool:
        """True when ``run_fused`` can execute this trainer's backend."""
        return self.mix_impl in _LM_FUSED_BACKENDS

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

    # -- the round's pieces (in place on params, opt_state, cstate) ---------

    def _per_node(self, params: PyTree, toks: torch.Tensor, labels: torch.Tensor,
                  fn) -> torch.Tensor:
        """(N,) values of ``fn(params[i], batch i)``, node ``i`` on its own
        (unstacked) params and its batch."""
        return torch.stack([
            fn(tree_map(lambda x, i=i: x[i], params),
               {"tokens": toks[i], "labels": labels[i]})
            for i in range(self.num_nodes)
        ])

    def _local_step(self, toks: torch.Tensor, labels: torch.Tensor, lr) -> torch.Tensor:
        """One optimizer step on every node; returns the mean loss (0-dim)."""
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(self.params)]
        with torch.enable_grad():
            losses = self._per_node(tree_unflatten(self.params, leaves), toks, labels,
                                    self._loss_fn)
            grads = torch.autograd.grad(losses.sum(), leaves)
        del leaves
        if self.use_adamw:
            adamw.update_(list(grads), self.opt_state, self.params, lr=lr)
        else:
            sgd.update_(list(grads), self.opt_state, self.params, lr=lr, mu=0.5)
        return losses.detach().mean()

    @torch.no_grad()
    def _freeze_dead(self, alive: torch.Tensor, p_in: list[torch.Tensor],
                     o_in: list[torch.Tensor]) -> None:
        """Dead nodes back to their pre-round params and moments (the
        reference's ``where_alive`` / ``where_alive_stacked``): ``p_in`` and
        ``o_in`` are the leaves before the step, in ``tree_leaves`` order;
        shared leaves (AdamW's count) pass through."""
        n = self.num_nodes
        for new, old in zip(tree_leaves(self.params) + tree_leaves(self.opt_state),
                            p_in + o_in):
            if new.dim() and new.shape[0] == n:
                new.copy_(torch.where(faults_mod._node_mask(alive, new), new, old))

    @torch.no_grad()
    def _gossip(self, mix_leaf: Callable[[torch.Tensor], torch.Tensor]) -> None:
        """One gossip exchange, leaf by leaf, through ``mix_leaf`` (a leaf ->
        mixed leaf map). Without compression: DecAvg. With it, CHOCO: each
        node publishes the top-k of ``params - reference`` (the reference
        advances by it), peers mix the references, and each node keeps its
        residual, ``params + W @ ref - ref``."""
        if self.compress is None:
            for p in tree_leaves(self.params):
                p.copy_(mix_leaf(p))
            return
        for p, ref in zip(tree_leaves(self.params), tree_leaves(self.cstate.reference)):
            _, state = compress_mod.compress([p], compress_mod.CompressState([ref]),
                                             k_frac=self.compress)
            ref.copy_(state.reference[0])
            del state
            p.copy_((p.float() + (mix_leaf(ref) - ref)).to(p.dtype))

    # -- metrics / checkpoint -------------------------------------------------

    @torch.no_grad()
    def consensus(self) -> np.ndarray:
        return consensus_distance(self.params).cpu().numpy()

    @torch.no_grad()
    def _domain_eval(self, toks: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """(N,) per-node mean true-token probability on the held-out
        foreign-domain eval batch (``domain_acc``)."""

        def node_eval(p, batch):
            logits, _ = TF.forward(p, self.cfg, batch["tokens"], remat=False)
            logp = torch.log_softmax(logits.float(), dim=-1)
            ll = logp.gather(-1, batch["labels"].long().unsqueeze(-1)).squeeze(-1)
            return torch.exp(ll).mean()

        return self._per_node(self.params, toks, labels, node_eval)

    def domain_metrics(self) -> dict:
        """G2-style knowledge-spread metrics on the token task: per-node
        ``domain_acc`` on *other* nodes' domain tokens, and their cohort mean
        ``g2_token_spread`` (the store/analysis join key)."""
        if self.num_nodes < 2:
            return {}
        from repro_torch.data import tokens as tok

        if self._eval_data is None:
            toks, labels = tok.domain_eval_batch(
                self.num_nodes, self.batch, self.seq, self.cfg.vocab_size, seed=self.seed,
                **{k: v for k, v in self.data_kwargs.items() if k == "domain_size"},
            )
            self._eval_data = (torch.as_tensor(toks, device=self.device),
                               torch.as_tensor(labels, device=self.device))
        accs = self._domain_eval(*self._eval_data).cpu().numpy()
        return {
            "domain_acc": [round(float(a), 6) for a in accs],
            "g2_token_spread": float(accs.mean()),
        }

    def _ckpt_tree(self) -> dict:
        tree = {"params": self.params, "opt": self.opt_state}
        if self.cstate is not None:
            tree["cstate"] = self.cstate
        return tree

    def save(self, path: str, *, step: int) -> None:
        """Checkpoint ``(params, opt[, cstate])`` plus the step: everything a
        bit-identical resume needs (the reference's npz layout)."""
        from repro_torch.checkpoint import ckpt

        ckpt.save(path, self._ckpt_tree(), step=step)

    def restore(self, path: str) -> int:
        """Restore a ``save`` checkpoint; the next ``run``/``run_fused``
        continues from the round after the saved step, re-deriving the same
        batches and LR the uninterrupted run would have seen."""
        from repro_torch.checkpoint import ckpt

        if self._has_hist:
            raise ValueError(
                "resume does not compose with straggler faults: the "
                "delayed-snapshot ring buffer is not checkpointed"
            )
        tree, step = ckpt.restore(path, self._ckpt_tree())
        if step is None:
            raise ValueError(f"checkpoint {path!r} carries no step")
        self.params, self.opt_state = tree["params"], tree["opt"]
        if self.cstate is not None:
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

    def _batch(self, r: int) -> tuple[torch.Tensor, torch.Tensor]:
        from repro_torch.data import tokens as tok

        toks, labels = tok.round_token_batch(
            self.num_nodes, r, self.batch, self.seq, self.cfg.vocab_size,
            seed=self.seed, **self.data_kwargs,
        )
        return (torch.as_tensor(toks, device=self.device),
                torch.as_tensor(labels, device=self.device))

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
        toks, labels = self._batch(rounds - 1)
        loss = self._per_node(self.params, toks, labels, self._loss_fn).mean()
        rec = self._round_record(rounds - 1, loss, self._sched(rounds - 1), t0)
        self._emit(rec, on_round, verbose, "(resume already complete)")
        return [rec]

    def _begin(self, rounds: int) -> bool:
        """Per-run set-up; True when a restored run has nothing left."""
        self._sched = schedules.get(self.schedule_name, self.lr, rounds)
        return self.start_round >= rounds

    # -- run paths --------------------------------------------------------------

    def run(
        self,
        rounds: int,
        *,
        eval_every: int = 1,
        on_round: Callable[[dict], None] | None = None,
        ckpt_every: int = 0,
        ckpt_path: str = "",
        verbose: bool = False,
    ) -> list[dict]:
        """Per-round Python loop: the local step and ``engine.mix``, eagerly."""
        _check_mesh(self.engine, self.device)
        t0 = time.perf_counter()
        if self._begin(rounds):
            return self._finished_resume(rounds, on_round, verbose, t0)
        evals = set(DecentralizedTrainer._eval_rounds(rounds, eval_every))
        cpts = self._ckpt_rounds(rounds, ckpt_every)
        trace = None
        if self.faulted:
            trace = self.engine.fault_trace
            trace.ensure(rounds)
        history: list[dict] = []
        for r in range(self.start_round, rounds):
            toks, labels = self._batch(r)
            lr = self._sched(r).to(self.device)
            if self.faulted:
                alive = torch.as_tensor(trace.alive(r), device=self.device)
                p_in = [x.clone() for x in tree_leaves(self.params)]
                o_in = [x.clone() for x in tree_leaves(self.opt_state)]
                loss = self._local_step(toks, labels, lr)
                self._freeze_dead(alive, p_in, o_in)
                del p_in, o_in
                # The renormalized faulted mix, and the engine's straggler
                # ring (one call per round, in order).
                with torch.no_grad():
                    _copy_into(self.params, self.engine.mix(self.params, round=r))
            else:
                loss = self._local_step(toks, labels, lr)
                if self.engine.is_gossip_round(r):
                    self.engine.refresh(r)
                    self._gossip(lambda q: self.engine.mix([q])[0])
            if r in evals:
                rec = self._round_record(r, loss, lr, t0)
                history.append(rec)
                self._emit(rec, on_round, verbose)
            if r in cpts:
                self.save(ckpt_path, step=r)
        return history

    def run_fused(
        self,
        rounds: int,
        *,
        eval_every: int = 1,
        on_round: Callable[[dict], None] | None = None,
        ckpt_every: int = 0,
        ckpt_path: str = "",
        verbose: bool = False,
    ) -> list[dict]:
        """``run`` from a staged program; on the card, captured CUDA graphs.

        Rounds go in chunks that end at the eval and checkpoint rounds (so
        checkpoints land on exact round boundaries). A chunk's token slab is
        drawn on the host for just its rounds and copied to the device; each
        round refills the static batch and round buffers and replays the
        local-step graph and, on gossip rounds, its period slot's gossip
        graph. Supported for the dense, sparse and sparse_pallas backends.
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
        program = self.engine.program(rounds, kind=self.mix_impl)
        evals = set(DecentralizedTrainer._eval_rounds(rounds, eval_every))
        cpts = self._ckpt_rounds(rounds, ckpt_every)
        staged = _LMFusedRounds(self, program)
        history: list[dict] = []
        prev = self.start_round - 1
        try:
            for end in sorted(evals | cpts):
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
            staged.close()
        return history


class _LMFusedRounds:
    """The rounds of one ``LMCohortTrainer.run_fused`` call.

    Static buffers: the trainer's params, optimizer state and compression
    reference (updated in place), the round's token batch ``toks``/``labels``
    and the round ``r`` (an int64 0-dim tensor), both refilled before each
    round, and ``loss``, the round's mean loss. The schedule's LR is
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
        self.hist = None
        self.p_in = self.o_in = None
        if program.faulted:
            self.p_in = [torch.empty_like(x) for x in tree_leaves(trainer.params)]
            self.o_in = [torch.empty_like(x) for x in tree_leaves(trainer.opt_state)]
            if program.delay_max > 0:
                self.hist = faults_mod.init_history(trainer.params, program.delay_max + 1)
        self.graphs: dict[Any, Staged] = {}
        self.ran: set = set()
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
        self._loss.copy_(tr._local_step(self.toks, self.labels, tr._sched(self.r)))
        if self.program.faulted:
            tr._freeze_dead(self.program.alive_at(self.r), self.p_in, self.o_in)
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
            tr._gossip(lambda q: prog.apply_period([q], t)[0])

    def _run(self, key, fn: Callable[[], None]) -> None:
        if self.stream is None:
            fn()
            return
        staged = self.graphs.get(key)
        if staged is None:
            if key not in self.ran:
                self.ran.add(key)
                current = torch.cuda.current_stream(self.device)
                self.stream.wait_stream(current)
                with torch.cuda.stream(self.stream):
                    fn()
                current.wait_stream(self.stream)
                return
            # The eager run's transients go back to the card before the
            # capture takes its own pool.
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            staged = self.graphs[key] = Staged(fn, self.device, stream=self.stream,
                                               pool=self.pool)
        staged()

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
