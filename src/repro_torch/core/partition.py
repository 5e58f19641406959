"""Non-IID data partitioners from the paper's §5.1.

Given a labeled dataset and a graph, assign per-node index sets:

- ``iid``: uniform random split of everything.
- ``hub_focused`` / ``edge_focused``: all nodes get an equal share of the G1
  classes (0-4); the G2 classes (5-9) go only to the 10% highest- (lowest-)
  degree nodes, with the paper's tie-breaking rule: walk degrees from the
  extreme inward, and if taking every node at the boundary degree would
  overshoot 10%, pick a random subset at that degree to fill exactly 10%.
- ``community``: for SBM — community ``c`` receives classes {2c, 2c+1}
  exclusively (classes 8, 9 discarded for 4 communities).
- ``dirichlet``: standard Dir(beta) label-skew partitioner (not in the paper;
  used by the extended benchmarks).

Partitioners return a list of per-node integer index arrays into the dataset.
Each node receives an equal share of every class it is assigned (paper: "on
the assigned classes, each node gets the same amount of images").
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.topology import Graph

__all__ = [
    "select_extreme_degree_nodes",
    "iid",
    "hub_focused",
    "edge_focused",
    "community",
    "dirichlet",
    "partition_summary",
]


def _split_class_evenly(
    idx: np.ndarray, recipients: Sequence[int], rng: np.random.Generator
) -> dict[int, np.ndarray]:
    """Shuffle ``idx`` and deal equal-size shares to ``recipients``
    (drop the remainder so shares are exactly equal, as in the paper)."""
    idx = idx.copy()
    rng.shuffle(idx)
    k = len(recipients)
    share = len(idx) // k
    return {node: idx[i * share : (i + 1) * share] for i, node in enumerate(recipients)}


def select_extreme_degree_nodes(
    g: Graph, frac: float, *, highest: bool, seed: int
) -> np.ndarray:
    """Pick ``frac`` of nodes by extreme degree with the paper's tie-break.

    Starting from the highest (lowest) degree, take whole degree classes while
    they fit; at the boundary degree, sample uniformly without replacement to
    fill the quota exactly.
    """
    rng = np.random.default_rng(seed)
    n = g.num_nodes
    quota = max(1, int(round(frac * n)))
    deg = g.degrees()
    order = np.argsort(-deg if highest else deg, kind="stable")
    chosen: list[int] = []
    i = 0
    while len(chosen) < quota:
        d = deg[order[i]]
        tier = [int(v) for v in order[i:] if deg[v] == d]
        if len(chosen) + len(tier) <= quota:
            chosen.extend(tier)
        else:
            need = quota - len(chosen)
            chosen.extend(rng.choice(tier, size=need, replace=False).tolist())
        i += len(tier)
    return np.asarray(sorted(chosen), dtype=np.int64)


def iid(labels: np.ndarray, num_nodes: int, *, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(labels))
    return [np.sort(s) for s in np.array_split(idx, num_nodes)]


def _focused(
    labels: np.ndarray,
    g: Graph,
    *,
    highest: bool,
    seed: int,
    g1_classes: Sequence[int] = (0, 1, 2, 3, 4),
    g2_classes: Sequence[int] = (5, 6, 7, 8, 9),
    frac: float = 0.10,
) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    n = g.num_nodes
    focus = select_extreme_degree_nodes(g, frac, highest=highest, seed=seed + 1)
    per_node: list[list[np.ndarray]] = [[] for _ in range(n)]
    all_nodes = list(range(n))
    focus_nodes = [int(v) for v in focus]
    for c in g1_classes:
        for node, share in _split_class_evenly(np.flatnonzero(labels == c), all_nodes, rng).items():
            per_node[node].append(share)
    for c in g2_classes:
        for node, share in _split_class_evenly(np.flatnonzero(labels == c), focus_nodes, rng).items():
            per_node[node].append(share)
    return [np.sort(np.concatenate(parts)) if parts else np.empty(0, np.int64) for parts in per_node]


def hub_focused(labels: np.ndarray, g: Graph, *, seed: int, **kw) -> list[np.ndarray]:
    """G2 classes concentrated on the 10% highest-degree nodes."""
    return _focused(labels, g, highest=True, seed=seed, **kw)


def edge_focused(labels: np.ndarray, g: Graph, *, seed: int, **kw) -> list[np.ndarray]:
    """G2 classes concentrated on the 10% lowest-degree nodes (leaves)."""
    return _focused(labels, g, highest=False, seed=seed, **kw)


def community(
    labels: np.ndarray, g: Graph, *, seed: int, classes_per_community: int = 2
) -> list[np.ndarray]:
    """SBM partition: community c exclusively holds classes
    [c*k, c*k + k); leftover classes are discarded (paper: 8 and 9)."""
    if g.blocks is None:
        raise ValueError("community partition requires an SBM graph with block labels")
    rng = np.random.default_rng(seed)
    n = g.num_nodes
    per_node: list[list[np.ndarray]] = [[] for _ in range(n)]
    num_comm = int(g.blocks.max()) + 1
    for comm in range(num_comm):
        members = [int(v) for v in np.flatnonzero(g.blocks == comm)]
        for c in range(comm * classes_per_community, (comm + 1) * classes_per_community):
            for node, share in _split_class_evenly(np.flatnonzero(labels == c), members, rng).items():
                per_node[node].append(share)
    return [np.sort(np.concatenate(parts)) if parts else np.empty(0, np.int64) for parts in per_node]


def dirichlet(
    labels: np.ndarray, num_nodes: int, *, beta: float, seed: int
) -> list[np.ndarray]:
    """Label-skew Dir(beta) partitioner (beyond-paper; common FL baseline)."""
    rng = np.random.default_rng(seed)
    num_classes = int(labels.max()) + 1
    buckets: list[list[int]] = [[] for _ in range(num_nodes)]
    for c in range(num_classes):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        props = rng.dirichlet([beta] * num_nodes)
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for node, share in enumerate(np.split(idx, cuts)):
            buckets[node].extend(share.tolist())
    return [np.sort(np.asarray(b, dtype=np.int64)) for b in buckets]


def partition_summary(labels: np.ndarray, parts: list[np.ndarray]) -> np.ndarray:
    """(num_nodes, num_classes) label-count matrix, for tests and reports."""
    num_classes = int(labels.max()) + 1
    out = np.zeros((len(parts), num_classes), dtype=np.int64)
    for i, p in enumerate(parts):
        if len(p):
            cls, cnt = np.unique(labels[p], return_counts=True)
            out[i, cls] = cnt
    return out
