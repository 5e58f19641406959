"""The paper's non-IID splits (its section 5.1), drawn from the run's seed.

- ``iid``: a uniform random split of every example.
- ``hub_focused`` / ``edge_focused``: every node gets an equal share of each
  G1 class (0-4); the G2 classes (5-9) go only to the 10% of nodes of
  highest (lowest) degree, walking degrees from the extreme inward and
  filling the boundary degree by a random draw.
- ``community``: community c alone holds classes {2c, 2c + 1}.

Each node receives an equal share of every class it is given, the remainder
dropped. A frozen copy of the repository's partitioners; only numpy.
"""

from __future__ import annotations

import numpy as np

__all__ = ["split", "holds_g2"]

G1 = (0, 1, 2, 3, 4)
G2 = (5, 6, 7, 8, 9)


def _deal(idx: np.ndarray, nodes: list[int], rng: np.random.Generator) -> dict[int, np.ndarray]:
    idx = idx.copy()
    rng.shuffle(idx)
    share = len(idx) // len(nodes)
    return {v: idx[i * share:(i + 1) * share] for i, v in enumerate(nodes)}


def _extreme(deg: np.ndarray, frac: float, highest: bool, rng: np.random.Generator) -> list[int]:
    quota = max(1, int(round(frac * len(deg))))
    order = np.argsort(-deg if highest else deg, kind="stable")
    chosen: list[int] = []
    i = 0
    while len(chosen) < quota:
        d = deg[order[i]]
        tier = [int(v) for v in order[i:] if deg[v] == d]
        if len(chosen) + len(tier) <= quota:
            chosen.extend(tier)
        else:
            chosen.extend(rng.choice(tier, size=quota - len(chosen), replace=False).tolist())
        i += len(tier)
    return sorted(chosen)


def split(kind: str, labels: np.ndarray, graph, seed: int) -> list[np.ndarray]:
    """Per-node sorted example indices for the split ``kind``."""
    n = graph.n
    rng = np.random.default_rng(np.random.SeedSequence([seed, 2]))
    if kind == "iid":
        return [np.sort(s) for s in np.array_split(rng.permutation(len(labels)), n)]
    per_node: list[list[np.ndarray]] = [[] for _ in range(n)]
    if kind in ("hub_focused", "edge_focused"):
        focus = _extreme(graph.degrees(), 0.10, kind == "hub_focused", rng)
        for classes, nodes in ((G1, list(range(n))), (G2, focus)):
            for c in classes:
                for v, share in _deal(np.flatnonzero(labels == c), nodes, rng).items():
                    per_node[v].append(share)
    elif kind == "community":
        for comm in range(int(graph.blocks.max()) + 1):
            members = [int(v) for v in np.flatnonzero(graph.blocks == comm)]
            for c in (2 * comm, 2 * comm + 1):
                for v, share in _deal(np.flatnonzero(labels == c), members, rng).items():
                    per_node[v].append(share)
    else:
        raise ValueError(f"unknown split {kind!r}")
    return [np.sort(np.concatenate(p)) if p else np.empty(0, np.int64) for p in per_node]


def holds_g2(labels: np.ndarray, parts: list[np.ndarray]) -> np.ndarray:
    """(N,) bool: the nodes that hold any G2 example (the rest are the
    nodes G2 knowledge has to spread to)."""
    g2 = np.isin(labels, G2)
    return np.array([bool(g2[p].any()) for p in parts])
