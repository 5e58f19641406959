"""Network-topology generators, the topology registry, and graph metrics.

Implements the three families studied in the paper (§4): Erdős–Rényi (ER),
Barabási–Albert (BA) and the Stochastic Block Model (SBM), plus the wider
catalog the follow-up literature sweeps (ring, star, complete, k-regular,
grid/torus, Watts–Strogatz small-world, connected caveman) and the metrics
the paper's analysis relies on (degree distribution, connectivity threshold
p*, modularity, per-community external-edge counts).

Every family is registered in a single string-spec factory::

    make("ba:n=100,m=2")            # one call site for every layer
    make("ring", n=8)               # caller defaults fill missing params
    make_schedule("er:n=64@regen=5")  # time-varying graph, new ER every 5 rounds

Spec grammar (see README for the catalog table)::

    spec   := family [":" params] ["@" schedule]
    params := key "=" value ("," key "=" value)*
    value  := int | float | bool | int ("+" int)*        # "+"-joined int list
    schedule := ("regen" | "rewire") "=" every ["," "frac" "=" float]

Everything is pure numpy (seeded, deterministic); graphs are returned as a
small `Graph` dataclass holding a dense boolean adjacency matrix — at the
paper's scale (N=100) dense is both simpler and faster on accelerators, and
the sparse mixing path (core/sparse.py) compresses W downstream for large N.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import numpy as np

__all__ = [
    "Graph",
    "TopologyFamily",
    "TopologySchedule",
    "make",
    "make_schedule",
    "parse_spec",
    "available",
    "families",
    "register",
    "erdos_renyi",
    "barabasi_albert",
    "stochastic_block_model",
    "ring",
    "star",
    "complete",
    "k_regular",
    "grid_2d",
    "watts_strogatz",
    "connected_caveman",
    "er_critical_p",
    "degree",
    "connected_components",
    "modularity",
    "external_edge_counts",
    "clustering_coefficient",
    "graph_summary",
]


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected, unweighted graph as a dense symmetric adjacency matrix.

    Attributes:
      adj: (N, N) bool ndarray, symmetric, zero diagonal.
      blocks: optional (N,) int ndarray of community labels (SBM only).
      name: human-readable description of the generator + params.
    """

    adj: np.ndarray
    blocks: np.ndarray | None = None
    name: str = "graph"

    def __post_init__(self):
        a = self.adj
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"adjacency must be square, got {a.shape}")
        if a.dtype != np.bool_:
            raise ValueError("adjacency must be boolean")
        if not np.array_equal(a, a.T):
            raise ValueError("adjacency must be symmetric (undirected graph)")
        if np.any(np.diag(a)):
            raise ValueError("adjacency must have a zero diagonal")

    @property
    def num_nodes(self) -> int:
        return self.adj.shape[0]

    @property
    def num_edges(self) -> int:
        return int(self.adj.sum()) // 2

    def degrees(self) -> np.ndarray:
        return degree(self.adj)

    def neighbors(self, i: int) -> np.ndarray:
        return np.flatnonzero(self.adj[i])


def er_critical_p(n: int) -> float:
    """Sharp connectivity threshold p* = ln(N)/N for ER graphs [Erdős–Rényi 1960]."""
    return math.log(n) / n


def erdos_renyi(n: int, p: float, *, seed: int) -> Graph:
    """ER random graph: each of the C(n,2) edges exists i.i.d. w.p. ``p``."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"p must be in [0,1], got {p}")
    rng = np.random.default_rng(seed)
    upper = rng.random((n, n)) < p
    adj = np.triu(upper, k=1)
    adj = adj | adj.T
    return Graph(adj=adj, name=f"er(n={n},p={p})")


def barabasi_albert(n: int, m: int, *, seed: int) -> Graph:
    """BA preferential-attachment graph.

    Starts from a star over the first ``m + 1`` nodes, then each new node
    attaches to ``m`` distinct existing nodes sampled proportionally to their
    current degree (the classic repeated-nodes urn construction).
    """
    if m < 1 or m >= n:
        raise ValueError(f"need 1 <= m < n, got m={m}, n={n}")
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n), dtype=np.bool_)
    # Seed graph: star over nodes [0, m] — every node has degree >= 1 so the
    # preferential urn is well defined from the first attachment step.
    for i in range(1, m + 1):
        adj[0, i] = adj[i, 0] = True
    # Urn of endpoints: one entry per half-edge, so sampling uniformly from it
    # is sampling proportionally to degree.
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
    return Graph(adj=adj, name=f"ba(n={n},m={m})")


def stochastic_block_model(
    block_sizes: Sequence[int],
    p_in: float | Sequence[float],
    p_out: float,
    *,
    seed: int,
) -> Graph:
    """SBM with within-block prob ``p_in`` (scalar or per-block) and
    cross-block prob ``p_out``."""
    sizes = np.asarray(block_sizes, dtype=np.int64)
    n = int(sizes.sum())
    b = len(sizes)
    p_in_vec = np.full(b, p_in, dtype=np.float64) if np.isscalar(p_in) else np.asarray(p_in, dtype=np.float64)
    if p_in_vec.shape != (b,):
        raise ValueError("p_in must be scalar or one value per block")
    labels = np.repeat(np.arange(b), sizes)
    # Edge probability matrix P[i, j] by block membership.
    pmat = np.full((n, n), p_out, dtype=np.float64)
    same = labels[:, None] == labels[None, :]
    pmat[same] = p_in_vec[labels[np.nonzero(same)[0]]]
    rng = np.random.default_rng(seed)
    upper = rng.random((n, n)) < pmat
    adj = np.triu(upper, k=1)
    adj = adj | adj.T
    return Graph(
        adj=adj,
        blocks=labels,
        name=f"sbm(sizes={list(block_sizes)},p_in={p_in},p_out={p_out})",
    )


# ---------------------------------------------------------------------------
# Beyond-paper deterministic + small-world families (registry catalog)
# ---------------------------------------------------------------------------


def _empty(n: int) -> np.ndarray:
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")
    return np.zeros((n, n), dtype=np.bool_)


def ring(n: int) -> Graph:
    """Cycle graph: node i <-> i+1 mod n (the classic decentralized baseline)."""
    adj = _empty(n)
    if n > 1:
        for i in range(n):
            adj[i, (i + 1) % n] = adj[(i + 1) % n, i] = True
    return Graph(adj=adj, name=f"ring:n={n}")


def star(n: int) -> Graph:
    """Hub-and-spokes: node 0 connected to all others (extreme hub topology)."""
    adj = _empty(n)
    adj[0, 1:] = adj[1:, 0] = True
    return Graph(adj=adj, name=f"star:n={n}")


def complete(n: int) -> Graph:
    """Fully connected graph — the FedAvg-like all-to-all upper baseline."""
    adj = ~np.eye(n, dtype=np.bool_)
    return Graph(adj=adj, name=f"complete:n={n}")


def k_regular(n: int, k: int) -> Graph:
    """Circulant k-regular graph: each node links to its k/2 nearest ring
    neighbors on each side (k even; odd k additionally links antipodes and
    needs even n)."""
    if not 0 < k < n:
        raise ValueError(f"need 0 < k < n, got k={k}, n={n}")
    if k % 2 and n % 2:
        raise ValueError(f"odd k={k} needs even n, got n={n}")
    adj = _empty(n)
    for off in range(1, k // 2 + 1):
        for i in range(n):
            j = (i + off) % n
            adj[i, j] = adj[j, i] = True
    if k % 2:
        for i in range(n // 2):
            adj[i, i + n // 2] = adj[i + n // 2, i] = True
    return Graph(adj=adj, name=f"kreg:n={n},k={k}")


def grid_2d(rows: int, cols: int, *, periodic: bool = False) -> Graph:
    """2-D lattice (``grid``) or its wrap-around version (``torus``)."""
    if rows < 1 or cols < 1:
        raise ValueError(f"need rows, cols >= 1, got {rows}x{cols}")
    n = rows * cols
    adj = _empty(n)

    def idx(r: int, c: int) -> int:
        return r * cols + c

    for r in range(rows):
        for c in range(cols):
            right = (r, c + 1)
            down = (r + 1, c)
            for rr, cc in (right, down):
                if periodic:
                    rr, cc = rr % rows, cc % cols
                elif rr >= rows or cc >= cols:
                    continue
                i, j = idx(r, c), idx(rr, cc)
                if i != j:
                    adj[i, j] = adj[j, i] = True
    kind = "torus" if periodic else "grid"
    return Graph(adj=adj, name=f"{kind}:rows={rows},cols={cols}")


def watts_strogatz(n: int, k: int, beta: float, *, seed: int) -> Graph:
    """Watts–Strogatz small world: circulant k-regular lattice with each
    edge rewired to a uniform random endpoint with probability ``beta``."""
    if not 0.0 <= beta <= 1.0:
        raise ValueError(f"beta must be in [0,1], got {beta}")
    if k % 2 or not 0 < k < n:
        raise ValueError(f"need even 0 < k < n, got k={k}, n={n}")
    rng = np.random.default_rng(seed)
    adj = k_regular(n, k).adj.copy()
    for off in range(1, k // 2 + 1):
        for i in range(n):
            j = (i + off) % n
            if rng.random() < beta and adj[i, j]:
                candidates = np.flatnonzero(~adj[i])
                candidates = candidates[candidates != i]
                if len(candidates):
                    new_j = int(rng.choice(candidates))
                    adj[i, j] = adj[j, i] = False
                    adj[i, new_j] = adj[new_j, i] = True
    return Graph(adj=adj, name=f"ws:n={n},k={k},beta={beta},seed={seed}")


def connected_caveman(cliques: int, size: int) -> Graph:
    """Connected caveman graph: ``cliques`` complete graphs of ``size`` nodes
    arranged in a ring; one edge per clique is rewired to bridge to the next
    clique — maximal clustering with a thin inter-community backbone (the
    deterministic extreme of the paper's SBM modularity axis)."""
    if cliques < 1 or size < 2:
        raise ValueError(f"need cliques >= 1 and size >= 2, got {cliques}, {size}")
    if cliques > 1 and size < 3:
        # Bridging rewires each clique's (lo, lo+1) edge; for 2-cliques that
        # is the clique's only edge and node lo+1 would be left isolated.
        raise ValueError(f"bridged caveman needs size >= 3, got size={size}")
    n = cliques * size
    adj = _empty(n)
    for c in range(cliques):
        lo = c * size
        adj[lo : lo + size, lo : lo + size] = True
    np.fill_diagonal(adj, False)
    if cliques > 1:
        for c in range(cliques):
            lo = c * size
            # Rewire the (lo, lo+1) in-clique edge to bridge to the next clique.
            adj[lo, lo + 1] = adj[lo + 1, lo] = False
            nxt = (lo + size) % n
            adj[lo, nxt] = adj[nxt, lo] = True
    blocks = np.repeat(np.arange(cliques), size)
    return Graph(adj=adj, blocks=blocks, name=f"caveman:cliques={cliques},size={size}")


# ---------------------------------------------------------------------------
# Topology registry: one string-spec factory for every layer of the system
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TopologyFamily:
    """One registered graph family.

    ``builder(seed=..., **params) -> Graph`` must set ``Graph.name`` to the
    canonical spec string so specs round-trip: ``make(g.name)`` rebuilds g.
    """

    name: str
    builder: Callable[..., Graph]
    defaults: dict[str, Any]
    required: tuple[str, ...]
    stochastic: bool
    example: str
    doc: str


_REGISTRY: dict[str, TopologyFamily] = {}
_ALIASES: dict[str, str] = {}


def register(
    name: str,
    *,
    aliases: Sequence[str] = (),
    defaults: dict[str, Any] | None = None,
    required: Sequence[str] = ("n",),
    stochastic: bool = False,
    example: str = "",
    doc: str = "",
) -> Callable[[Callable[..., Graph]], Callable[..., Graph]]:
    """Register a ``builder(seed=..., **params) -> Graph`` under ``name``."""

    def deco(fn: Callable[..., Graph]) -> Callable[..., Graph]:
        fam = TopologyFamily(
            name=name,
            builder=fn,
            defaults=dict(defaults or {}),
            required=tuple(required),
            stochastic=stochastic,
            example=example or name,
            doc=doc or next(iter((fn.__doc__ or "").strip().splitlines()), ""),
        )
        _REGISTRY[name] = fam
        for a in aliases:
            _ALIASES[a] = name
        return fn

    return deco


def available() -> list[str]:
    """Canonical names of every registered family."""
    return sorted(_REGISTRY)


def families() -> dict[str, TopologyFamily]:
    """The registry itself (read-only view for docs/tests)."""
    return dict(_REGISTRY)


def _parse_value(v: str) -> Any:
    if "+" in v:
        parts = v.split("+")
        try:
            return [int(p) for p in parts]
        except ValueError:
            pass
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            continue
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    return v


def parse_spec(spec: str) -> tuple[str, dict[str, Any], str | None]:
    """Split ``"family:key=val,...@sched"`` into (family, params, sched)."""
    spec = spec.strip()
    sched: str | None = None
    if "@" in spec:
        spec, sched = spec.split("@", 1)
    name, _, paramstr = spec.partition(":")
    name = name.strip().lower()
    if not name:
        raise ValueError(f"empty topology family in spec {spec!r}")
    params: dict[str, Any] = {}
    for kv in paramstr.split(","):
        kv = kv.strip()
        if not kv:
            continue
        k, eq, v = kv.partition("=")
        if not eq:
            raise ValueError(f"malformed param {kv!r} in spec {spec!r} (want key=value)")
        params[k.strip()] = _parse_value(v.strip())
    return name, params, sched


def _lookup(name: str) -> TopologyFamily:
    canon = _ALIASES.get(name, name)
    if canon not in _REGISTRY:
        raise ValueError(
            f"unknown topology family {name!r}; available: {', '.join(available())}"
        )
    return _REGISTRY[canon]


def _build(name: str, params: dict[str, Any], seed: int, defaults: dict[str, Any]) -> Graph:
    fam = _lookup(name)
    allowed = set(fam.defaults) | set(fam.required) | {"seed"}
    merged = dict(fam.defaults)
    for k, v in defaults.items():  # caller fallbacks (e.g. n from --nodes)
        if k in allowed and k != "seed":
            merged[k] = v
    merged.update(params)  # spec params win
    seed = int(merged.pop("seed", seed))
    unknown = set(merged) - (allowed - {"seed"})
    if unknown:
        raise ValueError(
            f"unknown params {sorted(unknown)} for family {fam.name!r}; "
            f"allowed: {sorted(allowed)}"
        )
    missing = [k for k in fam.required if merged.get(k) is None]
    if missing:
        raise ValueError(f"family {fam.name!r} needs params {missing} (spec or kwargs)")
    merged = {k: v for k, v in merged.items() if v is not None}
    return fam.builder(seed=seed, **merged)


def make(spec: str, *, seed: int = 0, **defaults: Any) -> Graph:
    """Build a Graph from a registry spec string.

    ``defaults`` fill params absent from the spec (spec always wins); ``seed``
    is the fallback when the spec carries no ``seed=`` param. The returned
    graph's ``.name`` is the canonical spec and round-trips through ``make``.
    """
    name, params, sched = parse_spec(spec)
    if sched is not None:
        raise ValueError(
            f"spec {spec!r} has a schedule suffix; build it with make_schedule()"
        )
    return _build(name, params, seed, defaults)


# -- registered builders (wrap the public generators, set canonical names) --


@register("er", aliases=("erdos_renyi",), defaults={"n": None, "p": None},
          stochastic=True, example="er:n=100,p=0.05",
          doc="Erdos-Renyi G(n,p); p defaults to 2*ln(n)/n (above p*)")
def _make_er(*, seed: int, n: int, p: float | None = None) -> Graph:
    p = 2.0 * er_critical_p(n) if p is None else p
    g = erdos_renyi(n, p, seed=seed)
    return dataclasses.replace(g, name=f"er:n={n},p={p},seed={seed}")


@register("ba", aliases=("barabasi_albert",), defaults={"n": None, "m": 2},
          stochastic=True, example="ba:n=100,m=2",
          doc="Barabasi-Albert preferential attachment, m edges per new node")
def _make_ba(*, seed: int, n: int, m: int = 2) -> Graph:
    g = barabasi_albert(n, m, seed=seed)
    return dataclasses.replace(g, name=f"ba:n={n},m={m},seed={seed}")


@register("sbm", aliases=("stochastic_block_model",),
          defaults={"n": None, "blocks": 4, "sizes": None, "p_in": 0.5, "p_out": 0.01},
          required=(), stochastic=True, example="sbm:n=100,blocks=4,p_in=0.5,p_out=0.01",
          doc="Stochastic block model; equal blocks from n or explicit sizes=a+b+...")
def _make_sbm(
    *,
    seed: int,
    n: int | None = None,
    blocks: int = 4,
    sizes: Sequence[int] | None = None,
    p_in: float = 0.5,
    p_out: float = 0.01,
) -> Graph:
    if sizes is None:
        if n is None:
            raise ValueError("sbm needs n (equal blocks) or sizes=a+b+...")
        if n % blocks:
            raise ValueError(f"sbm: n={n} not divisible by blocks={blocks}")
        sizes = [n // blocks] * blocks
    g = stochastic_block_model(sizes, p_in, p_out, seed=seed)
    canon = "+".join(str(int(s)) for s in sizes)
    return dataclasses.replace(
        g, name=f"sbm:sizes={canon},p_in={p_in},p_out={p_out},seed={seed}"
    )


@register("ring", aliases=("cycle",), defaults={"n": None}, example="ring:n=16",
          doc="Cycle graph (degree 2)")
def _make_ring(*, seed: int, n: int) -> Graph:
    return ring(n)


@register("star", defaults={"n": None}, example="star:n=16",
          doc="Hub-and-spokes (node 0 is the hub)")
def _make_star(*, seed: int, n: int) -> Graph:
    return star(n)


@register("complete", aliases=("full",), defaults={"n": None}, example="complete:n=16",
          doc="Fully connected all-to-all")
def _make_complete(*, seed: int, n: int) -> Graph:
    return complete(n)


@register("kreg", aliases=("k_regular", "regular"), defaults={"n": None, "k": 4},
          example="kreg:n=16,k=4", doc="Circulant k-regular ring lattice")
def _make_kreg(*, seed: int, n: int, k: int = 4) -> Graph:
    return k_regular(n, k)


def _near_square(n: int) -> tuple[int, int]:
    r = int(math.isqrt(n))
    while n % r:
        r -= 1
    return r, n // r


@register("grid", defaults={"n": None, "rows": None, "cols": None}, required=(),
          example="grid:rows=4,cols=5", doc="2-D lattice (non-periodic)")
def _make_grid(*, seed: int, n: int | None = None, rows: int | None = None,
               cols: int | None = None) -> Graph:
    if rows is None or cols is None:
        if n is None:
            raise ValueError("grid needs rows+cols or n")
        rows, cols = _near_square(n)
    return grid_2d(rows, cols, periodic=False)


@register("torus", defaults={"n": None, "rows": None, "cols": None}, required=(),
          example="torus:rows=4,cols=4", doc="2-D lattice with wrap-around (degree 4)")
def _make_torus(*, seed: int, n: int | None = None, rows: int | None = None,
                cols: int | None = None) -> Graph:
    if rows is None or cols is None:
        if n is None:
            raise ValueError("torus needs rows+cols or n")
        rows, cols = _near_square(n)
    return grid_2d(rows, cols, periodic=True)


@register("ws", aliases=("watts_strogatz", "smallworld"),
          defaults={"n": None, "k": 4, "beta": 0.1}, stochastic=True,
          example="ws:n=100,k=4,beta=0.1",
          doc="Watts-Strogatz small world (ring lattice with beta rewiring)")
def _make_ws(*, seed: int, n: int, k: int = 4, beta: float = 0.1) -> Graph:
    return watts_strogatz(n, k, beta, seed=seed)


@register("caveman", aliases=("connected_caveman",),
          defaults={"n": None, "cliques": None, "size": 5}, required=(),
          example="caveman:cliques=4,size=5",
          doc="Connected caveman: ring of cliques (max modularity)")
def _make_caveman(*, seed: int, n: int | None = None, cliques: int | None = None,
                  size: int = 5) -> Graph:
    if cliques is None:
        if n is None:
            raise ValueError("caveman needs cliques or n")
        if n % size:
            raise ValueError(f"caveman: n={n} not divisible by size={size}")
        cliques = n // size
    return connected_caveman(cliques, size)


# ---------------------------------------------------------------------------
# Time-varying topologies
# ---------------------------------------------------------------------------


class TopologySchedule:
    """A (possibly time-varying) sequence of graphs, indexed by round.

    Modes:
      static  — one fixed graph for all rounds.
      regen   — regenerate the family with a fresh seed every ``every`` rounds
                (i.i.d. graph resampling, e.g. per-round random matchings).
      rewire  — rewire ``frac`` of the base graph's edges (random remove +
                random add, node count preserved) every ``every`` rounds; each
                period rewires the *base* graph independently, so any period
                is reproducible from (seed, period) alone.

    ``graph_at(t)`` is cached per period; consumers that precompute per-graph
    state (mixing matrices, CSR) should key it on ``period_of(t)``.
    """

    def __init__(
        self,
        family: str,
        params: dict[str, Any] | None = None,
        *,
        mode: str = "static",
        every: int = 0,
        frac: float = 0.1,
        seed: int = 0,
        defaults: dict[str, Any] | None = None,
        graph: Graph | None = None,
    ):
        if mode not in ("static", "regen", "rewire"):
            raise ValueError(f"unknown schedule mode {mode!r}")
        if mode != "static" and every < 1:
            raise ValueError(f"mode {mode!r} needs every >= 1, got {every}")
        if not 0.0 < frac <= 1.0 and mode == "rewire":
            raise ValueError(f"rewire frac must be in (0,1], got {frac}")
        self.family = family
        self.params = dict(params or {})
        self.mode = mode
        self.every = int(every)
        self.frac = float(frac)
        self.seed = int(seed)
        self._defaults = dict(defaults or {})
        self._fixed = graph
        self._cache: tuple[int, Graph] | None = None

    @classmethod
    def static(cls, graph: Graph) -> "TopologySchedule":
        """Wrap an already-built Graph as a constant schedule."""
        return cls(family=graph.name, mode="static", graph=graph)

    @property
    def is_time_varying(self) -> bool:
        return self.mode != "static"

    @property
    def num_nodes(self) -> int:
        return self.graph_at(0).num_nodes

    def period_of(self, t: int) -> int:
        return 0 if not self.is_time_varying else int(t) // self.every

    def _base_graph(self) -> Graph:
        if self._fixed is None:
            self._fixed = _build(self.family, self.params, self.seed, self._defaults)
        return self._fixed

    def graph_at(self, t: int) -> Graph:
        period = self.period_of(t)
        if self._cache is not None and self._cache[0] == period:
            return self._cache[1]
        if self.mode == "static" or (self.mode == "rewire" and period == 0):
            g = self._base_graph()
        elif self.mode == "regen":
            g = _build(
                self.family, self.params, self.seed + 1_000_003 * period, self._defaults
            )
        else:  # rewire
            g = _rewire(self._base_graph(), self.frac, self.seed + 1_000_003 * period)
        self._cache = (period, g)
        return g

    def __repr__(self) -> str:
        if self.mode == "static":
            return f"TopologySchedule({self._base_graph().name})"
        return (
            f"TopologySchedule({self.family}:{self.params}@{self.mode}="
            f"{self.every},frac={self.frac})"
        )


def _rewire(g: Graph, frac: float, seed: int) -> Graph:
    """Rewire ``frac`` of the edges: remove k random edges, add k random
    non-edges. Degree sequence is not preserved; node count is."""
    rng = np.random.default_rng(seed)
    adj = g.adj.copy()
    ii, jj = np.nonzero(np.triu(adj, k=1))
    n_edges = len(ii)
    if n_edges == 0:
        return g
    k = max(1, int(round(frac * n_edges)))
    drop = rng.choice(n_edges, size=min(k, n_edges), replace=False)
    for e in drop:
        adj[ii[e], jj[e]] = adj[jj[e], ii[e]] = False
    ai, aj = np.nonzero(np.triu(~adj, k=1))
    free = len(ai)
    add = rng.choice(free, size=min(len(drop), free), replace=False)
    for e in add:
        adj[ai[e], aj[e]] = adj[aj[e], ai[e]] = True
    return Graph(adj=adj, blocks=g.blocks, name=f"{g.name}@rewired(seed={seed})")


def make_schedule(spec: str, *, seed: int = 0, **defaults: Any) -> TopologySchedule:
    """Build a TopologySchedule from a spec string.

    Without an ``@`` suffix the schedule is static. ``@regen=R`` resamples the
    family every R rounds; ``@rewire=R[,frac=F]`` rewires fraction F (default
    0.1) of the edges every R rounds.
    """
    name, params, sched = parse_spec(spec)
    mode, every, frac = "static", 0, 0.1
    if sched is not None:
        skv: dict[str, Any] = {}
        for kv in sched.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, eq, v = kv.partition("=")
            if not eq:
                raise ValueError(f"malformed schedule param {kv!r} in {spec!r}")
            skv[k.strip()] = _parse_value(v.strip())
        if "regen" in skv:
            mode, every = "regen", int(skv.pop("regen"))
        elif "rewire" in skv:
            mode, every = "rewire", int(skv.pop("rewire"))
        else:
            raise ValueError(f"schedule suffix needs regen= or rewire=, got {sched!r}")
        frac = float(skv.pop("frac", frac))
        if skv:
            raise ValueError(f"unknown schedule params {sorted(skv)} in {spec!r}")
    seed = int(params.pop("seed", seed))
    return TopologySchedule(
        name, params, mode=mode, every=every, frac=frac, seed=seed, defaults=defaults
    )


def degree(adj: np.ndarray) -> np.ndarray:
    return adj.sum(axis=1).astype(np.int64)


def connected_components(adj: np.ndarray) -> np.ndarray:
    """Label connected components via BFS. Returns (N,) int labels."""
    n = adj.shape[0]
    labels = np.full(n, -1, dtype=np.int64)
    cur = 0
    for start in range(n):
        if labels[start] >= 0:
            continue
        frontier = [start]
        labels[start] = cur
        while frontier:
            nxt: list[int] = []
            for u in frontier:
                for v in np.flatnonzero(adj[u]):
                    if labels[v] < 0:
                        labels[v] = cur
                        nxt.append(int(v))
            frontier = nxt
        cur += 1
    return labels


def modularity(adj: np.ndarray, communities: np.ndarray) -> float:
    """Newman modularity Q for a hard partition."""
    m2 = adj.sum()  # 2 * |E|
    if m2 == 0:
        return 0.0
    k = degree(adj).astype(np.float64)
    same = communities[:, None] == communities[None, :]
    q = (adj.astype(np.float64) - np.outer(k, k) / m2) * same
    return float(q.sum() / m2)


def clustering_coefficient(adj: np.ndarray) -> float:
    """Global (transitivity) clustering coefficient: 3*triangles / open triads."""
    a = adj.astype(np.float64)
    deg = a.sum(axis=1)
    triangles = float(np.trace(a @ a @ a)) / 6.0
    triads = float((deg * (deg - 1)).sum()) / 2.0
    return 0.0 if triads == 0 else 3.0 * triangles / triads


def graph_summary(g: Graph, *, max_dense_n: int = 2048) -> dict[str, Any]:
    """Realized-graph properties as one JSON-able dict.

    This is the graph side of the experiment harness's analysis join: every
    sweep run records ``graph_summary(realized graph)`` next to its training
    curves so topology properties (degree spread, modularity, clustering) can
    be regressed against knowledge-spread speed. O(N^3) quantities
    (clustering) are skipped above ``max_dense_n`` and reported as None.
    """
    deg = g.degrees().astype(np.float64)
    n = g.num_nodes
    comps = connected_components(g.adj)
    out: dict[str, Any] = {
        "name": g.name,
        "nodes": n,
        "edges": g.num_edges,
        "density": (2.0 * g.num_edges / (n * (n - 1))) if n > 1 else 0.0,
        "degree_min": int(deg.min()) if n else 0,
        "degree_max": int(deg.max()) if n else 0,
        "degree_mean": float(deg.mean()) if n else 0.0,
        "degree_std": float(deg.std()) if n else 0.0,
        "components": int(comps.max()) + 1 if n else 0,
        "modularity": None if g.blocks is None else modularity(g.adj, g.blocks),
        "clustering": clustering_coefficient(g.adj) if n <= max_dense_n else None,
    }
    return out


def external_edge_counts(g: Graph) -> np.ndarray:
    """Per-community counts of edges pointing to each other community
    (paper Table 1's bracketed numbers). Returns (B, B) with zero diagonal."""
    if g.blocks is None:
        raise ValueError("graph has no community labels")
    b = int(g.blocks.max()) + 1
    counts = np.zeros((b, b), dtype=np.int64)
    ii, jj = np.nonzero(np.triu(g.adj, k=1))
    for u, v in zip(ii, jj):
        bu, bv = g.blocks[u], g.blocks[v]
        if bu != bv:
            counts[bu, bv] += 1
            counts[bv, bu] += 1
    return counts
