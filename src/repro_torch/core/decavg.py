"""DecAvg: one communication round of decentralized averaging (paper Eq. 1).

All per-node model state is *node-stacked*: every leaf of the parameter tree
carries a leading ``node`` axis of size N. One communication round is the
linear map ``P <- W @ P`` applied leaf-wise, where W is the (N, N)
row-stochastic mixing matrix from core/mixing.py.

Four execution paths here, numerically equivalent (tests hold them to 3e-5):

1. ``mix_dense``  — ``torch.matmul`` per leaf, accumulating in the leaf dtype
                    (the reference's ``_mix_leaf`` contract). The default
                    below N=512.
2. ``mix_pallas`` — the hand-written CUDA ``gossip_mix`` kernel per
                    flattened leaf (kernels/gossip_mix.py), f32 accumulation.
                    The backend keeps the reference's name ``"pallas"`` so one
                    spec means the same run in both packages.
3. ``sparse``     — W as CSR, mixed over its ELL view in plain PyTorch in a
                    fixed order (core/sparse.py ``mix_ell``): O(E * P), the
                    default at N >= 512.
4. ``sparse_pallas`` — the CUDA sparse kernels (kernels/sparse_gossip.py):
                    the 8-row-blocked ELL kernel on the card.

``GossipEngine`` is the front door: it owns the topology (static graph or
TopologySchedule), builds the mixing matrix (and, for the sparse backends,
its CSR) per schedule period, resolves the backend and applies the per-round
gossip cadence. For fused runs, ``GossipEngine.program(rounds)`` stages
every schedule period up front as a ``MixingProgram`` (stacked dense W,
stacked ELL or stacked blocked-ELL tiles on the device), which the trainer's
``run_fused`` replays round by round. The reference's sharded and permute
backends are not ported yet and raise ``NotImplementedError`` naming the
slice that brings them.

With ``faults=`` (core/faults.py) the engine mixes the faulted round on the
``dense`` and ``sparse`` backends, as the reference does: each row
renormalized over its surviving entries, stale snapshots from stragglers,
dead and emptied rows passed through bit-unchanged; ``program()`` then also
stages the run's alive and entry-keep masks.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import faults as faults_mod
from repro_torch.core import mixing, sparse
from repro_torch.core import topology as topo
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["GossipEngine", "MixingProgram", "gossip_error", "mix_dense", "mix_pallas"]

PyTree = Any


def _mix_leaf(w: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """(N, N) x (N, ...) contraction over the node axis, in the leaf dtype."""
    n = w.shape[0]
    if leaf.shape[0] != n:
        raise ValueError(f"leaf leading axis {leaf.shape[0]} != num_nodes {n}")
    out = torch.matmul(w.to(torch.float32).to(leaf.dtype), leaf.reshape(n, -1))
    return out.reshape(leaf.shape)


def mix_dense(w: torch.Tensor, params: PyTree) -> PyTree:
    """DecAvg round via a per-leaf matmul (paper-faithful reference path)."""
    return tree_map(lambda leaf: _mix_leaf(w, leaf), params)


def mix_pallas(w: torch.Tensor, params: PyTree) -> PyTree:
    """DecAvg round via the CUDA gossip_mix kernel (per flattened leaf)."""

    def mix(leaf: torch.Tensor) -> torch.Tensor:
        flat = leaf.reshape(w.shape[0], -1)
        return ops.gossip_mix(w, flat).reshape(leaf.shape)

    return tree_map(mix, params)


# ---------------------------------------------------------------------------
# MixingProgram: all schedule periods staged up front for a fused run
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MixingProgram:
    """Every schedule period of a run, materialized as stacked operators.

    ``GossipEngine.program(rounds)`` builds one, and the trainer's
    ``run_fused`` mixes with it: on the card it captures one CUDA graph per
    period slot (``apply_period``) and replays the slot's graph on the
    rounds that gossip. The reference selects the slot by index inside a
    ``lax.scan``; here the host knows the slot and the cadence of every
    round, so ``period_idx`` and ``gossip_mask`` stay numpy arrays.

    - kind "dense": ``w`` is (T, N, N) f32 and each leaf mixes by matmul.
    - kind "sparse": per-period ELL views of the CSRs padded to a common K,
      ``ell_idx`` (T, N, K) int64 and ``ell_val`` (T, N, K) f32. Padding
      slots weigh 0 and come after the real ones, so they add exact zeros
      and a period mixes bit-identically to the loop's own layout.
    - kind "sparse_pallas": per-period blocked-ELL tiles padded to a common
      block count (``sparse.stack_block_ell``), ``bell_idx`` (T, NB, KB)
      int32 and ``bell_val`` (T, NB*8, KB*8) f32, mixed by the CUDA
      blocked-ELL kernel (its plain version on the CPU).

    ``cadence`` is "always" (gossip_every == 1), "never" (0) or "mask".
    ``pad_ratio`` is stacked operator slots per real W entry (1.0 for dense).

    A ``faulted`` program (kinds "dense" and "sparse") also holds the run's
    fault masks on the device: ``f_alive`` (rounds, N) bool, ``f_keep`` in
    the operator's own layout ((rounds, N, N) for dense, (rounds, N, K) over
    the ELL slots for sparse, padding slots kept) and the static straggler
    delays ``f_delay`` (N,). Its mixing takes the round ``r`` as an int or as
    an int64 device tensor: a captured graph reads the round's masks through
    the tensor, so one graph serves every round of a period slot.
    """

    kind: str  # "dense" | "sparse" | "sparse_pallas"
    n: int
    num_periods: int
    cadence: str  # "always" | "never" | "mask"
    period_idx: np.ndarray  # (rounds,) int32: round -> stacked period slot
    gossip_mask: np.ndarray  # (rounds,) bool
    p_chunk: int | None = None  # sparse gather feature-axis chunk
    w: torch.Tensor | None = None  # (T, N, N) f32, kind == "dense"
    ell_idx: torch.Tensor | None = None  # (T, N, K) int64, kind == "sparse"
    ell_val: torch.Tensor | None = None  # (T, N, K) f32
    bell_idx: torch.Tensor | None = None  # (T, NB, KB) int32, kind == "sparse_pallas"
    bell_val: torch.Tensor | None = None  # (T, NB*8, KB*8) f32
    pad_ratio: float = 1.0
    faulted: bool = False
    delay_max: int = 0
    f_alive: torch.Tensor | None = None  # (rounds, N) bool
    f_keep: torch.Tensor | None = None  # (rounds, N, N) | (rounds, N, K) bool
    f_delay: torch.Tensor | None = None  # (N,) int32

    @property
    def rounds(self) -> int:
        return int(self.period_idx.shape[0])

    def apply_period(self, params: PyTree, t: int, *, r=None, pub: PyTree = None) -> PyTree:
        """One unconditional mixing round with period slot ``t``'s operator.
        Reads only views of the stacked tensors, so it can be captured.

        On a faulted program, round ``r``'s masks (``r`` an int or an int64
        device tensor) renormalize the operator and ``pub`` supplies the
        published snapshots (defaults to ``params``, as in the reference's
        fused round)."""
        if self.faulted:
            if r is None:
                raise ValueError("a faulted program mixes at a round (r=...)")
            keep, alive = _row(self.f_keep, r), _row(self.f_alive, r)
            if pub is None:
                pub = params
            if self.kind == "dense":
                return faults_mod.mix_faulted_dense(self.w[t], keep, alive, params, pub)
            return faults_mod.mix_faulted_ell(
                self.ell_idx[t], self.ell_val[t], keep, alive, params, pub
            )
        if self.kind == "dense":
            return mix_dense(self.w[t], params)
        if self.kind == "sparse":
            return sparse.mix_ell(self.ell_idx[t], self.ell_val[t], params, p_chunk=self.p_chunk)
        return sparse.mix_kernel(
            ops.gossip_mix_sparse_blocked, self.bell_idx[t], self.bell_val[t], params
        )

    def alive_at(self, r) -> torch.Tensor:
        """Round ``r``'s (N,) alive mask on a faulted program (``r`` an int
        or an int64 device tensor)."""
        return _row(self.f_alive, r)

    def apply(self, params: PyTree, r: int, pub: PyTree = None) -> PyTree:
        """One unconditional mixing round with round ``r``'s operator (and,
        on a faulted program, its masks)."""
        return self.apply_period(params, int(self.period_idx[r]), r=r, pub=pub)

    def mix_at(self, params: PyTree, r: int, pub: PyTree = None) -> PyTree:
        """``apply`` gated by the gossip cadence (identity on skip rounds)."""
        if not self.gossip_mask[r]:
            return params
        return self.apply(params, r, pub)


def _row(x: torch.Tensor, r) -> torch.Tensor:
    """``x[r]``, where ``r`` may be an int64 device tensor: then an
    ``index_select`` on the device, so a captured graph reads the round from
    the tensor at replay instead of baking it in."""
    if isinstance(r, torch.Tensor):
        return x.index_select(0, r.reshape(1))[0]
    return x[r]


# ---------------------------------------------------------------------------
# GossipEngine
# ---------------------------------------------------------------------------

_MATRIX_KINDS = ("decavg", "uniform", "mh")
_SPARSE_KINDS = ("sparse", "sparse_pallas")

# Backend -> {requires, cost, wire, fused, faults, notes}, the same columns
# as the reference's table. ``fused`` means ``program()`` stages every
# schedule period for the backend, so ``DecentralizedTrainer.run_fused``
# covers it (its ``_FUSED_BACKENDS`` mirrors the flag). ``faults`` means the
# backend mixes the core/faults.py renormalized round: the kernels take W
# as it is, so per-round renormalization is dense and sparse territory, as
# in the reference.
_BACKEND_INFO = {
    "dense": {
        "requires": "any device; W materialized (N,N)",
        "cost": "O(N^2 * P)",
        "wire": "—",
        "fused": True,
        "faults": True,
        "notes": "torch.matmul per leaf; reference path",
    },
    "pallas": {
        "requires": "CUDA sm_90a (plain torch on CPU tensors); W materialized (N,N)",
        "cost": "O(N^2 * P), zero W tiles skipped",
        "wire": "—",
        "fused": False,
        "faults": False,
        "notes": "the hand-written CUDA gossip_mix kernel "
                 "(kernels/csrc/gossip_mix.cu); the name is the reference's",
    },
    "sparse": {
        "requires": "any device; W stored CSR, O(E) memory",
        "cost": "O(E * P)",
        "wire": "—",
        "fused": True,
        "faults": True,
        "notes": "ELL gather + fixed-order f32 sum (deterministic, no "
                 "atomics); default at N >= 512",
    },
    "sparse_pallas": {
        "requires": "CUDA sm_90a (plain torch on CPU tensors); W stored blocked ELL",
        "cost": "O(E * P), all-zero tiles skipped",
        "wire": "—",
        "fused": True,
        "faults": False,
        "notes": "the hand-written CUDA 8-row-blocked ELL kernel "
                 "(kernels/csrc/sparse_gossip.cu); scalar ELL row gather on "
                 "CPU tensors; the name is the reference's",
    },
}

# The reference's other backends, and the slice of the port that brings each.
_LATER_BACKENDS = {
    "sharded": "slice F",
    "sparse_sharded": "slice F",
    "permute": "slice F",
}


def _not_ported(backend: str) -> NotImplementedError:
    return NotImplementedError(
        f"backend {backend!r} is not ported yet ({_LATER_BACKENDS[backend]}); "
        f"the port runs {tuple(_BACKEND_INFO)}"
    )


class GossipEngine:
    """Owns topology, mixing matrix, backend dispatch and gossip cadence::

        engine = GossipEngine("ws:n=1024,k=8,beta=0.1", backend="auto")
        params = engine.mix(params, round=i)   # identity rounds are free

    Args:
      topology: a registry spec string (``"ba:n=100,m=2"``, may carry an
        ``@regen=``/``@rewire=`` schedule suffix), a built ``Graph``, or a
        ``TopologySchedule``.
      data_sizes: per-node |D_j| for the Eq. 1 weights (default: uniform).
      matrix: "decavg" (paper Eq. 1), "uniform" or "mh".
      backend: "dense", "pallas", "sparse", "sparse_pallas", or "auto"
        (sparse at N >= ``sparse_threshold``, else dense).
      gossip_every: mix on rounds with ``round % gossip_every == 0``; 0
        disables gossip (isolated training).
      sparse_p_chunk: feature-axis chunk for the sparse gather: an int,
        "auto" (sized from nnz to a ~16 MiB transient), or None (off).
      faults: a fault spec (core/faults.py grammar) or ``FaultSchedule``;
        needs a fault-capable backend (dense, sparse) and refuses
        ``sparse_p_chunk``. ``mix`` then needs ``round=``.
      validate: check every period's W (``mixing.validate_mixing``) and
        every staged CSR's row sums.
      device: where W lives and mixing runs; None means CUDA.
      **topology_defaults: fallback spec params (e.g. ``n=...``).
    """

    BACKENDS = tuple(_BACKEND_INFO)

    def __init__(
        self,
        topology,
        *,
        data_sizes: np.ndarray | None = None,
        matrix: str = "decavg",
        backend: str = "auto",
        gossip_every: int = 1,
        sparse_threshold: int = 512,
        sparse_p_chunk: int | str | None = None,
        faults: Any = None,
        validate: bool = True,
        seed: int = 0,
        device: str | torch.device | None = None,
        **topology_defaults,
    ):
        self.device = resolve_device(device)
        if isinstance(topology, str):
            topology = topo.make_schedule(topology, seed=seed, **topology_defaults)
        elif isinstance(topology, topo.Graph):
            topology = topo.TopologySchedule.static(topology)
        elif not isinstance(topology, topo.TopologySchedule):
            raise TypeError(f"topology must be spec/Graph/TopologySchedule, got {type(topology)}")
        self.schedule = topology
        self.num_nodes = topology.num_nodes
        if matrix not in _MATRIX_KINDS:
            raise ValueError(f"matrix must be one of {_MATRIX_KINDS}, got {matrix!r}")
        self.matrix = matrix
        self.data_sizes = (
            np.ones(self.num_nodes) if data_sizes is None
            else np.asarray(data_sizes, dtype=np.float64)
        )
        self.gossip_every = int(gossip_every)
        self.sparse_threshold = int(sparse_threshold)
        self.sparse_p_chunk = sparse_p_chunk
        self.validate = bool(validate)
        self.seed = int(seed)
        self.faults = None
        if faults is not None:
            self.faults = faults_mod.FaultSchedule.parse(faults)
            if sparse_p_chunk is not None:
                raise ValueError(
                    "faults do not compose with sparse_p_chunk: the faulted "
                    "mix renormalizes per entry, so chunked gathers would "
                    "redo it per chunk for no transient win"
                )
        self._fault_trace: faults_mod.FaultTrace | None = None
        self._fault_hist: PyTree = None  # loop-path straggler ring buffer (mix())
        self.backend = self._resolve_backend(backend)
        self.check(self.backend)
        self._period: int | None = None
        self._graph = None
        self._w: torch.Tensor | None = None
        self._csr: sparse.CSR | None = None
        self._ell: tuple[torch.Tensor, torch.Tensor] | None = None
        self._bell: tuple[torch.Tensor, torch.Tensor] | None = None
        self._ell_np: tuple[np.ndarray, np.ndarray] | None = None
        self.refresh(0)

    @classmethod
    def capabilities(cls) -> dict[str, dict[str, str | bool]]:
        """Backend -> {requires, cost, wire, fused, faults, notes}."""
        return {b: dict(info) for b, info in _BACKEND_INFO.items()}

    def _resolve_backend(self, backend: str) -> str:
        if backend == "auto":
            backend = "sparse" if self.num_nodes >= self.sparse_threshold else "dense"
        if backend in _BACKEND_INFO:
            return backend
        if backend in _LATER_BACKENDS:
            raise _not_ported(backend)
        raise ValueError(
            f"unknown backend {backend!r}; one of {self.BACKENDS} or 'auto'"
        )

    def check(self, backend: str) -> None:
        """Raise with an actionable message if ``backend`` cannot run here."""
        if backend in _LATER_BACKENDS:
            raise _not_ported(backend)
        if backend not in _BACKEND_INFO:
            raise ValueError(f"unknown backend {backend!r}; one of {self.BACKENDS}")
        if self.faults is not None and not _BACKEND_INFO[backend]["faults"]:
            capable = tuple(b for b, info in _BACKEND_INFO.items() if info["faults"])
            raise ValueError(
                f"backend {backend!r} does not support faults; "
                f"fault-capable backends: {capable}"
            )

    def refresh(self, round: int) -> bool:
        """Rebuild graph, W and CSR if ``round`` enters a new schedule period.
        Returns True when the mixing state changed."""
        period = self.schedule.period_of(round)
        if period == self._period:
            return False
        g = self.schedule.graph_at(round)
        if self.matrix == "decavg":
            w = mixing.decavg_matrix(g, self.data_sizes)
        elif self.matrix == "uniform":
            w = mixing.uniform_neighbor_matrix(g)
        else:
            w = mixing.metropolis_hastings_matrix(g)
        if self.validate:
            mixing.validate_mixing(w, g)
        self._period = period
        self._graph = g
        self._w = torch.as_tensor(np.asarray(w, np.float32), device=self.device)
        # Built from the edge list, as program() builds its stacked periods,
        # so the loop and fused paths mix with the same CSR values.
        self._csr = (
            sparse.csr_from_graph(g, self.data_sizes, matrix=self.matrix)
            if self.backend in _SPARSE_KINDS else None
        )
        self._ell = None  # device ELL view of _csr, built on first use
        self._bell = None  # device blocked-ELL view of _csr, built on first use
        self._ell_np = None  # its host arrays
        return True

    @property
    def graph(self):
        return self._graph

    @property
    def w(self) -> torch.Tensor:
        """Dense (N, N) f32 mixing matrix for the current period."""
        return self._w

    @property
    def csr(self) -> sparse.CSR:
        """The current period's W as CSR (host arrays)."""
        if self._csr is None:
            self._csr = sparse.csr_from_dense(self._w)
        return self._csr

    def w_at(self, round: int) -> torch.Tensor:
        self.refresh(round)
        return self._w

    def graph_at(self, round: int):
        self.refresh(round)
        return self._graph

    def is_gossip_round(self, round: int) -> bool:
        # gossip_every == 0 disables gossip entirely (isolated training).
        if self.gossip_every < 1:
            return False
        return self.gossip_every == 1 or round % self.gossip_every == 0

    def _p_chunk(self, nnz: int) -> int | None:
        if self.sparse_p_chunk == "auto":
            return sparse.auto_p_chunk(nnz)
        return None if self.sparse_p_chunk is None else int(self.sparse_p_chunk)

    @property
    def fault_trace(self) -> faults_mod.FaultTrace:
        """The engine's deterministic ``FaultTrace`` (requires ``faults=``),
        built on first use: loop mixing, fused staging and the runner's
        analytics read the same per-round masks."""
        if self.faults is None:
            raise ValueError("engine has no fault schedule (faults=...)")
        if self._fault_trace is None:
            self._fault_trace = faults_mod.FaultTrace(self.faults, self.schedule, seed=self.seed)
        return self._fault_trace

    def _ell_host(self) -> tuple[np.ndarray, np.ndarray]:
        if self._ell_np is None:
            self._ell_np = sparse.ell_from_csr(self.csr)
        return self._ell_np

    def _ell_view(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self._ell is None:
            idx, val = self._ell_host()
            self._ell = (
                torch.as_tensor(idx, dtype=torch.int64, device=self.device),
                torch.as_tensor(val, device=self.device),
            )
        return self._ell

    def _bell_view(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self._bell is None:
            b = sparse.block_ell_from_csr(self.csr)
            self._bell = (
                torch.as_tensor(b.idx, device=self.device),
                torch.as_tensor(b.val, device=self.device),
            )
        return self._bell

    def mix(
        self,
        params: PyTree,
        *,
        round: int | None = None,
        backend: str | None = None,
        spec: str | None = None,
    ) -> PyTree:
        """One communication round.

        With ``round`` given, the engine applies the cadence (identity rounds
        return ``params`` untouched) and refreshes schedule state for that
        round. Without it, the current-period matrix is applied
        unconditionally. ``backend`` (alias ``spec``) overrides the engine's
        backend for this call only; it is checked, and later calls are
        unaffected.

        With ``faults=`` set the engine runs the faulted round instead (it
        needs ``round``): straggler snapshots from an internal ring buffer
        that assumes one call per round, in round order; renormalized mixing
        over surviving neighbors; dead and emptied rows passed through
        bit-unchanged. Freezing dead nodes' training is the trainer's job.
        """
        backend = backend or spec or self.backend
        if backend != self.backend:
            self.check(backend)
        if self.faults is not None:
            if round is None:
                raise ValueError("faulted mixing needs round= (per-round masks)")
            return self._mix_faulted(params, round, backend)
        if round is not None:
            if not self.is_gossip_round(round):
                return params
            self.refresh(round)
        if backend == "dense":
            return mix_dense(self._w, params)
        if backend == "pallas":
            return mix_pallas(self._w, params)
        if backend == "sparse":
            idx, val = self._ell_view()
            return sparse.mix_ell(idx, val, params, p_chunk=self._p_chunk(self.csr.nnz))
        # sparse_pallas: the blocked kernel on the card; on the CPU the
        # scalar kernel's plain version, as the reference picks the scalar
        # kernel off the TPU.
        if self.device.type == "cuda":
            return sparse.mix_kernel(ops.gossip_mix_sparse_blocked, *self._bell_view(), params)
        return sparse.mix_kernel(ops.gossip_mix_sparse, *self._ell_view(), params)

    def _mix_faulted(self, params: PyTree, round: int, backend: str) -> PyTree:
        """One faulted loop-path round (see ``mix``)."""
        self.refresh(round)
        trace = self.fault_trace
        # Push into the straggler ring buffer BEFORE the cadence gate: a
        # straggler's history advances whether or not this round gossips.
        pub = None
        if trace.delay_max > 0:
            if self._fault_hist is None:
                self._fault_hist = faults_mod.init_history(params, trace.delay_max + 1)
            pub, _ = faults_mod.push_and_publish(
                params, self._fault_hist, round, self.fault_delay()
            )
        if not self.is_gossip_round(round):
            return params
        return self.mix_faulted(params, round, pub, backend=backend)

    def fault_delay(self) -> torch.Tensor:
        """The static per-node straggler delays, (N,) int32 on the device."""
        return torch.as_tensor(self.fault_trace.delay, device=self.device)

    def mix_faulted(self, params: PyTree, round: int, pub: PyTree = None, *,
                    backend: str | None = None) -> PyTree:
        """One unconditional faulted round with round ``round``'s masks over
        the current period's W (call ``refresh(round)`` first). ``pub`` are
        the published snapshots (None: every publish is fresh)."""
        backend = backend or self.backend
        trace = self.fault_trace
        alive = torch.as_tensor(trace.alive(round), device=self.device)
        if backend == "dense":
            keep = torch.as_tensor(trace.dense_keep(round), device=self.device)
            return faults_mod.mix_faulted_dense(self._w, keep, alive, params, pub)
        if backend == "sparse":
            idx, val = self._ell_host()
            rows = np.arange(self.num_nodes)[:, None]
            keep = trace.entry_keep(round, np.broadcast_to(rows, idx.shape), idx, val)
            return faults_mod.mix_faulted_ell(
                *self._ell_view(), torch.as_tensor(keep, device=self.device), alive, params, pub
            )
        raise ValueError(f"backend {backend!r} does not support faults")

    def program(self, rounds: int, *, kind: str | None = None) -> MixingProgram:
        """Stage every schedule period of a ``rounds``-long run up front.

        ``kind`` defaults to the backend for the sparse backends and "dense"
        otherwise. The sparse kinds build each period's CSR straight from the
        schedule's graphs (``sparse.csr_from_graph``), as ``refresh`` does,
        so the dense (N, N) matrix is never stacked. For the dense kind the
        engine's period state is walked and then restored to round 0.

        With ``faults=`` set, the program also stages the whole run's
        per-round alive and entry-keep masks and the static straggler delays
        (``_attach_faults``).
        """
        prog = self._program_operators(rounds, kind=kind)
        if self.faults is None:
            return prog
        return self._attach_faults(prog, int(rounds))

    def _attach_faults(self, prog: MixingProgram, rounds: int) -> MixingProgram:
        """The fault axis of a built program: per-round alive masks, and
        entry-keep masks in the program's own operator layout (dense W, or
        the ELL slots of each round's period with padding slots kept)."""
        if prog.kind not in ("dense", "sparse"):
            raise ValueError(f"program kind {prog.kind!r} does not support faults")
        trace = self.fault_trace
        trace.ensure(rounds)
        if prog.kind == "dense":
            keep = np.stack([trace.dense_keep(r) for r in range(rounds)])
        else:
            idx = prog.ell_idx.cpu().numpy()
            val = prog.ell_val.cpu().numpy()
            rows = np.broadcast_to(np.arange(prog.n)[:, None], idx.shape[1:])
            keep = np.stack([
                trace.entry_keep(r, rows, idx[t], val[t])
                for r, t in enumerate(prog.period_idx)
            ])
        return dataclasses.replace(
            prog,
            faulted=True,
            delay_max=trace.delay_max,
            f_alive=torch.as_tensor(trace.alive_matrix(rounds), device=self.device),
            f_keep=torch.as_tensor(keep, device=self.device),
            f_delay=torch.as_tensor(trace.delay, device=self.device),
        )

    def _program_operators(self, rounds: int, *, kind: str | None = None) -> MixingProgram:
        """The fault-free operator staging behind ``program`` (docs there)."""
        rounds = int(rounds)
        if rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {rounds}")
        if kind is None:
            kind = self.backend if self.backend in _SPARSE_KINDS else "dense"
        if kind not in ("dense",) + _SPARSE_KINDS:
            raise ValueError(
                f"program kind must be one of {('dense',) + _SPARSE_KINDS}, got {kind!r}"
            )
        first_round: dict[int, int] = {}
        for r in range(rounds):
            first_round.setdefault(self.schedule.period_of(r), r)
        period_list = sorted(first_round)
        slot = {p: i for i, p in enumerate(period_list)}
        common = dict(
            n=self.num_nodes,
            num_periods=len(period_list),
            cadence=(
                "never" if self.gossip_every < 1
                else "always" if self.gossip_every == 1
                else "mask"
            ),
            period_idx=np.array(
                [slot[self.schedule.period_of(r)] for r in range(rounds)], np.int32
            ),
            gossip_mask=np.array([self.is_gossip_round(r) for r in range(rounds)], bool),
        )
        if kind == "dense":
            ws = torch.stack([self.w_at(first_round[p]) for p in period_list])
            self.refresh(0)  # leave the engine where a fresh run expects it
            return MixingProgram(kind="dense", w=ws, **common)
        csrs = [
            sparse.csr_from_graph(
                self.schedule.graph_at(first_round[p]), self.data_sizes, matrix=self.matrix
            )
            for p in period_list
        ]
        for c in csrs if self.validate else ():  # O(E) row sums, no dense rebuild
            rs = np.bincount(c.rows, weights=c.values.astype(np.float64),
                             minlength=self.num_nodes)
            if not np.allclose(rs, 1.0, atol=1e-5):
                raise ValueError("staged mixing rows must sum to 1")
        real_nnz = sum(c.nnz for c in csrs)
        if kind == "sparse_pallas":
            bell_idx, bell_val = sparse.stack_block_ell(csrs)
            return MixingProgram(
                kind="sparse_pallas",
                bell_idx=torch.as_tensor(bell_idx, device=self.device),
                bell_val=torch.as_tensor(bell_val, device=self.device),
                pad_ratio=bell_val.size / real_nnz,
                **common,
            )
        ells = [sparse.ell_from_csr(c) for c in csrs]
        k = max(i.shape[1] for i, _ in ells)
        idx = np.stack([np.pad(i, ((0, 0), (0, k - i.shape[1]))) for i, _ in ells])
        val = np.stack([np.pad(v, ((0, 0), (0, k - v.shape[1]))) for _, v in ells])
        return MixingProgram(
            kind="sparse",
            ell_idx=torch.as_tensor(idx, dtype=torch.int64, device=self.device),
            ell_val=torch.as_tensor(val, device=self.device),
            p_chunk=self._p_chunk(max(c.nnz for c in csrs)),
            pad_ratio=val.size / real_nnz,
            **common,
        )

    def __repr__(self) -> str:
        return (
            f"GossipEngine(n={self.num_nodes}, backend={self.backend}, "
            f"matrix={self.matrix}, gossip_every={self.gossip_every}, "
            f"device={self.device}, topology={self.schedule!r})"
        )


def gossip_error(params: PyTree) -> torch.Tensor:
    """Consensus distance: mean over leaves of ||w_i - mean_i w_i||^2 / ||mean||^2.

    The quantity the spectral gap contracts per round; benchmarks report it
    to connect topology properties to knowledge-spread speed.
    """

    def leaf_err(leaf: torch.Tensor) -> torch.Tensor:
        f = leaf.reshape(leaf.shape[0], -1).float()
        mean = f.mean(dim=0, keepdim=True)
        num = ((f - mean) ** 2).sum()
        den = (mean**2).sum() * f.shape[0] + 1e-12
        return num / den

    return torch.stack([leaf_err(leaf) for leaf in tree_leaves(params)]).mean()
