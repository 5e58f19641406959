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
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import mixing, sparse
from repro_torch.core import topology as topo
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.tree import tree_map

__all__ = ["GossipEngine", "MixingProgram", "mix_dense", "mix_pallas"]

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

    @property
    def rounds(self) -> int:
        return int(self.period_idx.shape[0])

    def apply_period(self, params: PyTree, t: int) -> PyTree:
        """One unconditional mixing round with period slot ``t``'s operator.
        Reads only views of the stacked tensors, so it can be captured."""
        if self.kind == "dense":
            return mix_dense(self.w[t], params)
        if self.kind == "sparse":
            return sparse.mix_ell(self.ell_idx[t], self.ell_val[t], params, p_chunk=self.p_chunk)
        return sparse.mix_kernel(
            ops.gossip_mix_sparse_blocked, self.bell_idx[t], self.bell_val[t], params
        )

    def apply(self, params: PyTree, r: int) -> PyTree:
        """One unconditional mixing round with round ``r``'s operator."""
        return self.apply_period(params, int(self.period_idx[r]))

    def mix_at(self, params: PyTree, r: int) -> PyTree:
        """``apply`` gated by the gossip cadence (identity on skip rounds)."""
        if not self.gossip_mask[r]:
            return params
        return self.apply(params, r)


# ---------------------------------------------------------------------------
# GossipEngine
# ---------------------------------------------------------------------------

_MATRIX_KINDS = ("decavg", "uniform", "mh")
_SPARSE_KINDS = ("sparse", "sparse_pallas")

# Backend -> {requires, cost, wire, fused, faults, notes}, the same columns
# as the reference's table. ``fused`` means ``program()`` stages every
# schedule period for the backend, so ``DecentralizedTrainer.run_fused``
# covers it (its ``_FUSED_BACKENDS`` mirrors the flag).
_BACKEND_INFO = {
    "dense": {
        "requires": "any device; W materialized (N,N)",
        "cost": "O(N^2 * P)",
        "wire": "—",
        "fused": True,
        "faults": False,
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
        "faults": False,
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
        self.seed = int(seed)
        self.backend = self._resolve_backend(backend)
        self._period: int | None = None
        self._graph = None
        self._w: torch.Tensor | None = None
        self._csr: sparse.CSR | None = None
        self._ell: tuple[torch.Tensor, torch.Tensor] | None = None
        self._bell: tuple[torch.Tensor, torch.Tensor] | None = None
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

    def _ell_view(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self._ell is None:
            idx, val = sparse.ell_from_csr(self.csr)
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

    def mix(self, params: PyTree, *, round: int | None = None) -> PyTree:
        """One communication round.

        With ``round`` given, the engine applies the cadence (identity rounds
        return ``params`` untouched) and refreshes schedule state for that
        round. Without it, the current-period matrix is applied
        unconditionally.
        """
        if round is not None:
            if not self.is_gossip_round(round):
                return params
            self.refresh(round)
        if self.backend == "dense":
            return mix_dense(self._w, params)
        if self.backend == "pallas":
            return mix_pallas(self._w, params)
        if self.backend == "sparse":
            idx, val = self._ell_view()
            return sparse.mix_ell(idx, val, params, p_chunk=self._p_chunk(self.csr.nnz))
        # sparse_pallas: the blocked kernel on the card; on the CPU the
        # scalar kernel's plain version, as the reference picks the scalar
        # kernel off the TPU.
        if self.device.type == "cuda":
            return sparse.mix_kernel(ops.gossip_mix_sparse_blocked, *self._bell_view(), params)
        return sparse.mix_kernel(ops.gossip_mix_sparse, *self._ell_view(), params)

    def program(self, rounds: int, *, kind: str | None = None) -> MixingProgram:
        """Stage every schedule period of a ``rounds``-long run up front.

        ``kind`` defaults to the backend for the sparse backends and "dense"
        otherwise. The sparse kinds build each period's CSR straight from the
        schedule's graphs (``sparse.csr_from_graph``), as ``refresh`` does,
        so the dense (N, N) matrix is never stacked. For the dense kind the
        engine's period state is walked and then restored to round 0.
        """
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
        for c in csrs:  # O(E) row-stochasticity check, no dense rebuild
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
