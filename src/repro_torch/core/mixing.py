"""DecAvg mixing matrices (paper Eq. 1).

Eq. 1 averages, at node i, the models of the closed neighborhood N(i)
(neighbors + self) with weights proportional to trust * dataset size:

    w_i(t) <- sum_{j in N(i)} omega_ij * alpha_ij * w_j(t-1) / Z_i ,
    alpha_ij = |D_j| / sum_{k in N(i)} |D_k| .

Fidelity note: Eq. 1 as printed normalizes by Z_i = sum_j omega_ij, which for
unweighted graphs (omega=1) would shrink every row by 1/|N(i)| — a clearly
unintended contraction (models would collapse to zero). We use the standard
row-stochastic normalization Z_i = sum_j omega_ij * alpha_ij, which for
omega = 1 reduces to exactly the FedAvg-style dataset-size-weighted average
w_i <- sum_j alpha_ij w_j. This matches the paper's verbal description
("averages it with its local model ... weighted average") and its results.

The mixing matrix W (rows = receiving node i, cols = source node j) is the
single object the whole system consumes: one DecAvg communication round is
``P <- W @ P`` on node-stacked parameters.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.topology import Graph

__all__ = [
    "decavg_matrix",
    "uniform_neighbor_matrix",
    "metropolis_hastings_matrix",
    "validate_mixing",
    "spectral_gap",
]


def _closed_neighborhood(adj: np.ndarray) -> np.ndarray:
    return adj.astype(np.float64) + np.eye(adj.shape[0])


def decavg_matrix(
    g: Graph,
    data_sizes: np.ndarray,
    *,
    trust: np.ndarray | None = None,
    self_trust: float = 1.0,
) -> np.ndarray:
    """Paper Eq. 1 mixing matrix, row-stochastic.

    Args:
      g: the collaboration graph.
      data_sizes: (N,) per-node |D_j| (zero-size nodes contribute nothing).
      trust: optional (N, N) symmetric non-negative edge weights omega_ij;
        defaults to the unweighted case omega_ij = 1 on edges.
      self_trust: omega_ii, the paper's "self-trust pseudo-parameter".
    """
    n = g.num_nodes
    sizes = np.asarray(data_sizes, dtype=np.float64)
    if sizes.shape != (n,):
        raise ValueError(f"data_sizes must be ({n},), got {sizes.shape}")
    if trust is None:
        omega = g.adj.astype(np.float64)
    else:
        omega = np.asarray(trust, dtype=np.float64) * g.adj  # restrict to edges
        if not np.allclose(omega, omega.T):
            raise ValueError("trust matrix must be symmetric")
    np.fill_diagonal(omega, self_trust)
    w = omega * sizes[None, :]  # omega_ij * |D_j| over the closed neighborhood
    row = w.sum(axis=1, keepdims=True)
    if np.any(row == 0):
        # Isolated node with zero data: keep its own model unchanged.
        bad = row[:, 0] == 0
        w[bad] = 0.0
        w[bad, np.flatnonzero(bad)] = 1.0
        row = w.sum(axis=1, keepdims=True)
    return w / row


def uniform_neighbor_matrix(g: Graph) -> np.ndarray:
    """Uniform average over the closed neighborhood (alpha_ij = 1/|N(i)|)."""
    w = _closed_neighborhood(g.adj)
    return w / w.sum(axis=1, keepdims=True)


def metropolis_hastings_matrix(g: Graph) -> np.ndarray:
    """Symmetric, doubly-stochastic MH weights (beyond-paper baseline).

    W_ij = 1 / (1 + max(d_i, d_j)) on edges, W_ii = 1 - sum_j W_ij.
    Doubly-stochastic mixing preserves the global average — the classical
    gossip-averaging choice, giving the fastest consensus contraction for a
    given topology.
    """
    adj = g.adj
    d = adj.sum(axis=1).astype(np.float64)
    w = np.where(adj, 1.0 / (1.0 + np.maximum(d[:, None], d[None, :])), 0.0)
    np.fill_diagonal(w, 0.0)
    np.fill_diagonal(w, 1.0 - w.sum(axis=1))
    return w


def validate_mixing(w: np.ndarray, g: Graph | None = None, atol: float = 1e-9) -> None:
    """Assert W is a valid gossip matrix: row-stochastic, non-negative, and
    supported only on the closed neighborhood of ``g`` (if given)."""
    if np.any(w < -atol):
        raise ValueError("mixing matrix has negative entries")
    if not np.allclose(w.sum(axis=1), 1.0, atol=atol):
        raise ValueError("mixing matrix rows must sum to 1")
    if g is not None:
        support = _closed_neighborhood(g.adj) > 0
        if np.any((np.abs(w) > atol) & ~support):
            raise ValueError("mixing matrix has weight outside graph edges")


def edge_coloring(g: Graph) -> list[list[tuple[int, int]]]:
    """Decompose the graph's edges into matchings (greedy edge coloring,
    <= 2*Delta - 1 colors; typically Delta or Delta + 1).

    Each color class is a set of vertex-disjoint edges; emitted as DIRECTED
    pairs (both (i, j) and (j, i) — sources and destinations within a color
    are distinct, so one ``jax.lax.ppermute`` realizes the whole class).
    This is the topology-as-collective-schedule optimization (EXPERIMENTS
    §Perf H2): DecAvg only needs *neighbor* models, so gossip wire volume is
    O(degree) shards instead of the dense all-gather's O(N).
    """
    n = g.num_nodes
    used: list[set[int]] = [set() for _ in range(n)]
    color_of: dict[tuple[int, int], int] = {}
    ncolors = 0
    ii, jj = np.nonzero(np.triu(g.adj, k=1))
    for u, v in zip(ii.tolist(), jj.tolist()):
        c = 0
        while c in used[u] or c in used[v]:
            c += 1
        color_of[(u, v)] = c
        used[u].add(c)
        used[v].add(c)
        ncolors = max(ncolors, c + 1)
    colors: list[list[tuple[int, int]]] = [[] for _ in range(ncolors)]
    for (u, v), c in color_of.items():
        colors[c].append((u, v))
        colors[c].append((v, u))
    return colors


def spectral_gap(w: np.ndarray) -> float:
    """1 - |lambda_2(W)|: the consensus contraction rate per gossip round.

    Used by the analysis benchmarks to relate topology (connectivity,
    modularity) to knowledge-spread speed: small gap <=> slow spread.
    """
    eig = np.linalg.eigvals(w)
    mags = np.sort(np.abs(eig))[::-1]
    return float(1.0 - (mags[1] if len(mags) > 1 else 0.0))
