"""DecAvg: one communication round of decentralized averaging (paper Eq. 1).

All per-node model state is *node-stacked*: every leaf of the parameter tree
carries a leading ``node`` axis of size N. One communication round is the
linear map ``P <- W @ P`` applied leaf-wise, where W is the (N, N)
row-stochastic mixing matrix from core/mixing.py.

Two execution paths here, numerically equivalent (tests hold them to 3e-5):

1. ``mix_dense``  — ``torch.matmul`` per leaf, accumulating in the leaf dtype
                    (the reference's ``_mix_leaf`` contract). The default.
2. ``mix_pallas`` — the hand-written CUDA ``gossip_mix`` kernel per
                    flattened leaf (kernels/gossip_mix.py), f32 accumulation.
                    The backend keeps the reference's name ``"pallas"`` so one
                    spec means the same run in both packages.

``GossipEngine`` is the front door: it owns the topology (static graph or
TopologySchedule), builds the mixing matrix per schedule period, resolves the
backend and applies the per-round gossip cadence. The reference's sparse,
sharded and permute backends are not ported yet and raise
``NotImplementedError`` naming the slice that brings them.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import mixing
from repro_torch.core import topology as topo
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.tree import tree_map

__all__ = ["GossipEngine", "mix_dense", "mix_pallas"]

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


_MATRIX_KINDS = ("decavg", "uniform", "mh")

# Backend -> {requires, cost, wire, fused, faults, notes}, the same columns
# as the reference's table. ``fused`` is False for both: the port's trainer
# has no run_fused yet.
_BACKEND_INFO = {
    "dense": {
        "requires": "any device; W materialized (N,N)",
        "cost": "O(N^2 * P)",
        "wire": "—",
        "fused": False,
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
}

# The reference's other backends, and the slice of the port that brings each.
_LATER_BACKENDS = {
    "sparse": "slice B",
    "sparse_pallas": "slice B",
    "sharded": "slice D",
    "sparse_sharded": "slice D",
    "permute": "slice D",
}


def _not_ported(backend: str) -> NotImplementedError:
    return NotImplementedError(
        f"backend {backend!r} is not ported yet ({_LATER_BACKENDS[backend]}); "
        f"the port runs {tuple(_BACKEND_INFO)}"
    )


class GossipEngine:
    """Owns topology, mixing matrix, backend dispatch and gossip cadence::

        engine = GossipEngine("ba:n=100,m=2", backend="pallas")
        params = engine.mix(params, round=i)   # identity rounds are free

    Args:
      topology: a registry spec string (``"ba:n=100,m=2"``, may carry an
        ``@regen=``/``@rewire=`` schedule suffix), a built ``Graph``, or a
        ``TopologySchedule``.
      data_sizes: per-node |D_j| for the Eq. 1 weights (default: uniform).
      matrix: "decavg" (paper Eq. 1), "uniform" or "mh".
      backend: "dense", "pallas", or "auto" (dense below
        ``sparse_threshold`` nodes; at or above it the reference picks the
        sparse backend, which is not ported yet, so this raises).
      gossip_every: mix on rounds with ``round % gossip_every == 0``; 0
        disables gossip (isolated training).
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
        self.seed = int(seed)
        self.backend = self._resolve_backend(backend)
        self._period: int | None = None
        self._graph = None
        self._w: torch.Tensor | None = None
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
        """Rebuild graph and W if ``round`` enters a new schedule period.
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
        return True

    @property
    def graph(self):
        return self._graph

    @property
    def w(self) -> torch.Tensor:
        """Dense (N, N) f32 mixing matrix for the current period."""
        return self._w

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
        return mix_pallas(self._w, params)

    def __repr__(self) -> str:
        return (
            f"GossipEngine(n={self.num_nodes}, backend={self.backend}, "
            f"matrix={self.matrix}, gossip_every={self.gossip_every}, "
            f"device={self.device}, topology={self.schedule!r})"
        )
