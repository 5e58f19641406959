"""Collaboration graphs for the traffic files, as dense boolean adjacency.

Frozen copies of the paper's generators (Erdos-Renyi, Barabasi-Albert,
stochastic block model) and of the wider catalog's Watts-Strogatz and
connected caveman, each drawn from the traffic file's own fixed seed, so
every run of a cell has the same graph. Only numpy.

A traffic file names its graph as ``{"family": ..., "seed": ..., <params>}``
and ``make`` builds it; ``blocks`` are the SBM's and the caveman's
communities (None for the others).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np

__all__ = ["Graph", "make"]


@dataclasses.dataclass(frozen=True)
class Graph:
    adj: np.ndarray  # (N, N) bool, symmetric, zero diagonal
    blocks: np.ndarray | None = None

    @property
    def n(self) -> int:
        return self.adj.shape[0]

    def degrees(self) -> np.ndarray:
        return self.adj.sum(axis=1).astype(np.int64)

    @property
    def nnz(self) -> int:
        """Nonzeros of a mixing matrix over the closed neighbourhoods."""
        return int(self.adj.sum()) + self.n


def _sym(upper: np.ndarray) -> np.ndarray:
    adj = np.triu(upper, k=1)
    return adj | adj.T


def erdos_renyi(n: int, p: float | None, seed: int) -> Graph:
    """Every edge i.i.d. with probability ``p`` (default: ln(n)/n)."""
    p = math.log(n) / n if p is None else p
    rng = np.random.default_rng(seed)
    return Graph(_sym(rng.random((n, n)) < p))


def barabasi_albert(n: int, m: int, seed: int) -> Graph:
    """Preferential attachment from a star over the first ``m + 1`` nodes:
    each new node joins ``m`` distinct nodes drawn from the urn of
    half-edges, so in proportion to degree."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n), dtype=np.bool_)
    for i in range(1, m + 1):
        adj[0, i] = adj[i, 0] = True
    urn: list[int] = []
    for i in range(m + 1):
        urn.extend([i] * int(adj[i].sum()))
    for new in range(m + 1, n):
        targets: set[int] = set()
        while len(targets) < m:
            targets.add(int(urn[rng.integers(len(urn))]))
        for t in targets:
            adj[new, t] = adj[t, new] = True
            urn.extend([new, t])
    return Graph(adj)


def sbm(n: int, blocks: int, p_in: float, p_out: float, seed: int) -> Graph:
    """Equal blocks; edges inside a block with ``p_in``, across with ``p_out``."""
    label = np.repeat(np.arange(blocks), n // blocks)
    label = np.concatenate([label, np.full(n - len(label), blocks - 1)])
    same = label[:, None] == label[None, :]
    rng = np.random.default_rng(seed)
    return Graph(_sym(rng.random((n, n)) < np.where(same, p_in, p_out)), blocks=label)


def watts_strogatz(n: int, k: int, beta: float, seed: int) -> Graph:
    """A ring lattice of degree ``k``, each edge rewired with ``beta``."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n), dtype=np.bool_)
    for off in range(1, k // 2 + 1):
        i = np.arange(n)
        adj[i, (i + off) % n] = adj[(i + off) % n, i] = True
    for off in range(1, k // 2 + 1):
        for i in range(n):
            j = (i + off) % n
            if rng.random() < beta and adj[i, j]:
                free = np.flatnonzero(~adj[i])
                free = free[free != i]
                if len(free):
                    new = int(rng.choice(free))
                    adj[i, j] = adj[j, i] = False
                    adj[i, new] = adj[new, i] = True
    return Graph(adj)


def caveman(cliques: int, size: int) -> Graph:
    """``cliques`` complete graphs in a ring, one edge of each rewired to
    the next clique."""
    n = cliques * size
    adj = np.zeros((n, n), dtype=np.bool_)
    for c in range(cliques):
        lo = c * size
        adj[lo:lo + size, lo:lo + size] = True
    np.fill_diagonal(adj, False)
    for c in range(cliques if cliques > 1 else 0):
        a, b = c * size, c * size + 1
        nxt = ((c + 1) % cliques) * size
        adj[a, b] = adj[b, a] = False
        adj[a, nxt] = adj[nxt, a] = True
    return Graph(adj, blocks=np.repeat(np.arange(cliques), size))


def make(spec: dict[str, Any]) -> Graph:
    """The graph a traffic file's ``topology`` entry names."""
    kw = {k: v for k, v in spec.items() if k != "family"}
    family = spec["family"]
    if family == "ba":
        return barabasi_albert(kw["n"], kw.get("m", 2), kw["seed"])
    if family == "er":
        return erdos_renyi(kw["n"], kw.get("p"), kw["seed"])
    if family == "sbm":
        return sbm(kw["n"], kw.get("blocks", 4), kw.get("p_in", 0.5), kw.get("p_out", 0.01),
                   kw["seed"])
    if family == "ws":
        return watts_strogatz(kw["n"], kw.get("k", 4), kw.get("beta", 0.1), kw["seed"])
    if family == "caveman":
        return caveman(kw["cliques"], kw["size"])
    raise ValueError(f"unknown graph family {family!r}")
