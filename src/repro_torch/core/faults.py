"""Seeded, fully traceable fault injection: churn, stragglers, edge drops.

The port's copy of the reference's fault subsystem. Three fault families:

- ``churn`` — nodes leave and rejoin mid-run. Dead nodes freeze their
  parameters (a per-node ``where``, no shape changes) and drop out of every
  neighbor's mixing row.
- ``straggler`` — a static subset of nodes publishes *stale* parameter
  snapshots: each straggler gossips the params it held ``delay`` rounds ago
  (a bounded ring buffer of past params).
- ``drop`` — each undirected edge independently fails for one round with
  probability ``p_edge``; both directions drop together.

Spec grammar: clauses joined by ``";"``, each ``kind[:k=v,...][@targeted=...]``::

    "churn:p_leave=0.05,p_join=0.5@targeted=hubs"
    "straggler:frac=0.2,delay=3"
    "drop:p_edge=0.1"
    "churn:p_leave=1.0,p_join=0.0,frac=0.25,start=8@targeted=hubs;drop:p_edge=0.05"

``targeted`` restricts churn/straggler candidacy to the top (``hubs``) or
bottom (``leaves``) ``frac`` of nodes by degree; ``uniform`` (default)
draws from everyone. ``churn`` extras: ``frac`` bounds the candidate pool
and ``start`` delays the first departure. ``drop`` takes no target.

The host side (grammar and ``FaultTrace``) is numpy, drawn from the same
``SeedSequence`` stream in the same order as the reference, so both packages
see byte-identical masks for the same ``(seed, spec, topology)``. The device
side is torch: the fused trainer stages the masks on the device and reads a
round's rows from them, so every round-dependent value of a captured CUDA
graph comes from a buffer, never from a Python integer baked into it.

Renormalization semantics (loop and fused alike): given the round's
entry-keep mask, each W row is rescaled over its surviving entries so it
sums to 1; a row left with *no* surviving mass falls back to identity, and
dead nodes' params pass through bit-unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.topology import TopologySchedule, _parse_value
from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_map

__all__ = [
    "FaultClause",
    "FaultSchedule",
    "FaultTrace",
    "parse_faults",
    "renorm_dense",
    "renorm_values",
    "renorm_ell",
    "mix_faulted_dense",
    "mix_faulted_csr",
    "mix_faulted_ell",
    "faulted_ell_coefs",
    "faulted_ell_rows",
    "faulted_dense_w",
    "init_history",
    "push",
    "publish",
    "push_and_publish",
    "where_alive",
    "where_alive_stacked",
    "churn_rounds",
    "recovery_rounds",
]

PyTree = Any

_KINDS = ("churn", "straggler", "drop")
_TARGETS = ("uniform", "hubs", "leaves")
_DEFAULTS: dict[str, dict[str, Any]] = {
    "churn": {"p_leave": 0.1, "p_join": 0.5, "frac": 0.25, "start": 0},
    "straggler": {"frac": 0.2, "delay": 2},
    "drop": {"p_edge": 0.1},
}

# Domain tag mixed into the SeedSequence so fault draws never collide with
# topology/init/batch streams derived from the same run seed.
_FAULT_STREAM = 0xFA017


@dataclasses.dataclass(frozen=True)
class FaultClause:
    """One parsed clause: ``kind`` + resolved params + targeting mode."""

    kind: str
    params: Mapping[str, Any]
    target: str = "uniform"


def _parse_clause(text: str) -> FaultClause:
    text = text.strip()
    target = "uniform"
    if "@" in text:
        text, _, mod = text.partition("@")
        key, _, val = mod.partition("=")
        if key.strip() != "targeted":
            raise ValueError(f"unknown fault modifier {mod!r} (only @targeted=...)")
        target = val.strip()
        if target not in _TARGETS:
            raise ValueError(f"unknown fault target {target!r}; one of {_TARGETS}")
    kind, _, rest = text.partition(":")
    kind = kind.strip()
    if kind not in _KINDS:
        raise ValueError(f"unknown fault kind {kind!r}; one of {_KINDS}")
    if kind == "drop" and target != "uniform":
        raise ValueError("drop faults hit edges, not nodes: @targeted is invalid")
    params = dict(_DEFAULTS[kind])
    if rest.strip():
        for item in rest.split(","):
            key, eq, val = item.partition("=")
            key = key.strip()
            if not eq or key not in params:
                raise ValueError(
                    f"bad {kind} param {item.strip()!r}; known: {sorted(params)}"
                )
            params[key] = type(_DEFAULTS[kind][key])(_parse_value(val.strip()))
    for key in ("p_leave", "p_join", "frac", "p_edge"):
        if key in params and not 0.0 <= float(params[key]) <= 1.0:
            raise ValueError(f"{kind}:{key}={params[key]} outside [0, 1]")
    if kind == "straggler" and int(params["delay"]) < 1:
        raise ValueError(f"straggler delay must be >= 1, got {params['delay']}")
    return FaultClause(kind, params, target)


def parse_faults(spec: str) -> tuple[FaultClause, ...]:
    """Parse a fault spec string into clauses (see module docstring)."""
    clauses = tuple(_parse_clause(part) for part in spec.split(";") if part.strip())
    if not clauses:
        raise ValueError(f"empty fault spec {spec!r}")
    return clauses


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A parsed fault spec, hashable and comparable on the raw spec string."""

    spec: str
    clauses: tuple[FaultClause, ...]

    @classmethod
    def parse(cls, spec: "str | FaultSchedule") -> "FaultSchedule":
        if isinstance(spec, FaultSchedule):
            return spec
        return cls(spec=spec, clauses=parse_faults(spec))

    @property
    def has_churn(self) -> bool:
        return any(c.kind == "churn" for c in self.clauses)

    @property
    def has_drop(self) -> bool:
        return any(c.kind == "drop" for c in self.clauses)

    @property
    def has_stragglers(self) -> bool:
        return any(c.kind == "straggler" for c in self.clauses)

    @property
    def max_delay(self) -> int:
        return max(
            (int(c.params["delay"]) for c in self.clauses if c.kind == "straggler"),
            default=0,
        )


def _target_pool(clause: FaultClause, degrees: np.ndarray) -> np.ndarray:
    """Boolean candidate mask for a targeted churn/straggler clause."""
    n = degrees.shape[0]
    if clause.target == "uniform" and clause.kind == "churn":
        # churn's frac only narrows *targeted* pools; uniform churn may
        # touch anyone (p_leave already rate-limits departures).
        return np.ones(n, bool)
    k = max(1, int(np.ceil(float(clause.params["frac"]) * n)))
    # lexsort tie-break on node id keeps hub/leaf pools deterministic on
    # regular graphs where many degrees tie.
    if clause.target == "hubs":
        order = np.lexsort((np.arange(n), -degrees))
    elif clause.target == "leaves":
        order = np.lexsort((np.arange(n), degrees))
    else:  # uniform straggler: handled by the caller's rng.choice
        return np.ones(n, bool)
    pool = np.zeros(n, bool)
    pool[order[:k]] = True
    return pool


class FaultTrace:
    """Deterministic host-side expansion of a :class:`FaultSchedule`.

    Materializes per-round aliveness and edge-drop masks from
    ``np.random.SeedSequence([seed, 0xFA017])``, round by round: first the
    straggler picks, then each round both churn uniforms of every churn
    clause (whatever ``start`` is), then the edge-drop uniforms over the
    sorted ``i*n+j`` keys of the period's upper-triangle edges. Every
    consumer (loop trainer, fused program staging, runner analytics) sees
    the same masks.
    """

    def __init__(self, schedule: FaultSchedule | str, topo: TopologySchedule, *, seed: int = 0):
        self.schedule = FaultSchedule.parse(schedule)
        self.topo = topo
        self.seed = int(seed)
        self._rng = np.random.default_rng(np.random.SeedSequence([self.seed, _FAULT_STREAM]))
        g0 = topo.graph_at(0)
        self.n = g0.num_nodes
        deg0 = g0.degrees().astype(np.int64)
        # Straggler delays are static for the run, drawn from the period-0
        # graph (a straggler is a slow *device*, not a slow round).
        delay = np.zeros(self.n, np.int32)
        for clause in self.schedule.clauses:
            if clause.kind != "straggler":
                continue
            d = int(clause.params["delay"])
            if clause.target == "uniform":
                k = max(1, int(np.ceil(float(clause.params["frac"]) * self.n)))
                picks = self._rng.choice(self.n, size=k, replace=False)
                mask = np.zeros(self.n, bool)
                mask[picks] = True
            else:
                mask = _target_pool(clause, deg0)
            delay = np.maximum(delay, np.where(mask, d, 0).astype(np.int32))
        self.delay = delay
        self.delay_max = int(delay.max()) if self.n else 0
        self._alive = np.ones(self.n, bool)
        self._alive_rows: list[np.ndarray] = []
        self._drop_rows: list[np.ndarray] = []
        self._edge_cache: dict[int, np.ndarray] = {}

    def _edges(self, period: int) -> np.ndarray:
        """Sorted encoded (i*n+j, i<j) undirected edge keys for a period."""
        if period not in self._edge_cache:
            g = self.topo.graph_at(period * self.topo.every)
            i, j = np.nonzero(np.triu(np.asarray(g.adj, bool), 1))
            self._edge_cache[period] = i.astype(np.int64) * self.n + j
        return self._edge_cache[period]

    def _step(self, r: int) -> None:
        period = self.topo.period_of(r)
        degrees = self.topo.graph_at(r).degrees().astype(np.int64)
        alive = self._alive
        for clause in self.schedule.clauses:
            if clause.kind != "churn":
                continue
            # Both uniforms every round, whatever `start` is, so the stream
            # (and every later round's masks) does not depend on it.
            u_leave = self._rng.random(self.n)
            u_join = self._rng.random(self.n)
            if r < int(clause.params["start"]):
                continue
            pool = _target_pool(clause, degrees)
            leave = alive & pool & (u_leave < float(clause.params["p_leave"]))
            join = ~alive & (u_join < float(clause.params["p_join"]))
            alive = (alive & ~leave) | join
        self._alive = alive
        self._alive_rows.append(alive.copy())

        edges = self._edges(period)
        dropped = np.zeros(edges.shape[0], bool)
        for clause in self.schedule.clauses:
            if clause.kind != "drop":
                continue
            dropped |= self._rng.random(edges.shape[0]) < float(clause.params["p_edge"])
        self._drop_rows.append(edges[dropped])

    def ensure(self, rounds: int) -> None:
        """Extend the trace through round ``rounds - 1`` (incremental)."""
        while len(self._alive_rows) < rounds:
            self._step(len(self._alive_rows))

    def alive(self, r: int) -> np.ndarray:
        """(N,) bool aliveness after round ``r``'s churn transitions."""
        self.ensure(r + 1)
        return self._alive_rows[r]

    def alive_matrix(self, rounds: int) -> np.ndarray:
        """(rounds, N) bool alive masks, one row per round."""
        self.ensure(rounds)
        if not rounds:
            return np.zeros((0, self.n), bool)
        return np.stack(self._alive_rows[:rounds])

    def _dropped_keys(self, r: int) -> np.ndarray:
        self.ensure(r + 1)
        return self._drop_rows[r]

    def edge_kept(self, r: int, i: int, j: int) -> bool:
        """Did the undirected edge (i, j) survive round ``r``'s drops?"""
        lo, hi = (i, j) if i < j else (j, i)
        if lo == hi:
            return True
        key = lo * self.n + hi
        dropped = self._dropped_keys(r)
        pos = np.searchsorted(dropped, key)
        return not (pos < dropped.shape[0] and dropped[pos] == key)

    def dense_keep(self, r: int) -> np.ndarray:
        """(N, N) bool entry-keep mask for round ``r`` (dense W layout).

        Entry (i, j) survives iff both endpoints are alive and the edge was
        not dropped; the diagonal follows aliveness alone.
        """
        alive = self.alive(r)
        keep = alive[:, None] & alive[None, :]
        dropped = self._dropped_keys(r)
        if dropped.size:
            lo, hi = dropped // self.n, dropped % self.n
            keep[lo, hi] = False
            keep[hi, lo] = False
        return keep

    def entry_keep(
        self,
        r: int,
        rows_g: np.ndarray,
        cols_g: np.ndarray,
        values: np.ndarray | None = None,
    ) -> np.ndarray:
        """Entry-keep mask for arbitrary-shaped global-id (row, col) arrays.

        Covers every sparse layout: CSR entries, or ELL slots (rows broadcast
        over the slot axis). Pass ``values`` to keep the slots of value 0.0
        (padding): they contribute nothing either way, and keeping them
        avoids renormalizing over a phantom loss.
        """
        alive = self.alive(r)
        rows_g = np.asarray(rows_g)
        cols_g = np.asarray(cols_g)
        keep = alive[rows_g] & alive[cols_g]
        dropped = self._dropped_keys(r)
        offdiag = rows_g != cols_g
        if dropped.size and offdiag.any():
            lo = np.minimum(rows_g, cols_g).astype(np.int64)
            hi = np.maximum(rows_g, cols_g).astype(np.int64)
            key = lo * self.n + hi
            pos = np.searchsorted(dropped, key)
            pos = np.minimum(pos, dropped.shape[0] - 1)
            hit = (dropped[pos] == key) & offdiag
            keep = keep & ~hit
        if values is not None:
            keep = keep | (np.asarray(values) == 0.0)
        return keep


# ---------------------------------------------------------------------------
# Device side (torch): shared by the loop and fused paths
# ---------------------------------------------------------------------------


def renorm_dense(w: torch.Tensor, keep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero masked entries and rescale each row to sum 1.

    Returns ``(w_renorm, row_ok)`` where ``row_ok[i]`` is False iff row i
    lost *all* its mass (the caller falls back to identity there).
    """
    wk = w * keep
    rowsum = wk.sum(dim=1)
    ok = rowsum > 0
    return wk / torch.where(ok, rowsum, 1.0)[:, None], ok


def renorm_values(
    values: torch.Tensor, keep: torch.Tensor, rows: torch.Tensor, n: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """CSR-layout row renormalization (``rows`` sorted ascending)."""
    vk = values * keep
    rowsum = torch.zeros(n, dtype=vk.dtype, device=vk.device).index_add_(0, rows.long(), vk)
    ok = rowsum > 0
    inv = torch.where(ok, 1.0, 0.0) / torch.where(ok, rowsum, 1.0)
    return vk * inv[rows.long()], ok


def renorm_ell(val: torch.Tensor, keep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """ELL-layout row renormalization: ``val`` and ``keep`` are (N, K).
    Each row's sum runs slot by slot in slot order, so it does not depend
    on how many rows or trailing zero-weight slots the layout has (a shard's
    rows sum to the same bits as in the whole matrix)."""
    vk = val * keep
    rowsum = vk[:, 0].clone()
    for k in range(1, vk.shape[1]):
        rowsum.add_(vk[:, k])
    ok = rowsum > 0
    inv = torch.where(ok, 1.0, 0.0) / torch.where(ok, rowsum, 1.0)
    return vk * inv[:, None], ok


def _flat(p: torch.Tensor) -> torch.Tensor:
    return p.reshape(p.shape[0], -1).float()


def mix_faulted_dense(
    w: torch.Tensor,
    keep: torch.Tensor,
    alive: torch.Tensor,
    params: PyTree,
    pub: PyTree = None,
) -> PyTree:
    """One faulted dense DecAvg round on a node-stacked tree.

    Mixes the *published* snapshots ``pub`` (stale for stragglers; defaults
    to ``params``) under the renormalized surviving W, while each node's own
    contribution stays fresh: ``out = (Wf - diag(Wf)) @ pub + diag(Wf) * cur``.
    Rows with no surviving mass, and dead destination nodes, pass their
    current params through bit-unchanged.
    """
    wn, ok = renorm_dense(w, keep)
    okr = (ok & alive)[:, None]

    if pub is None:
        # Every publish is fresh: the diagonal correction is identically 0.
        def leaf(p: torch.Tensor) -> torch.Tensor:
            pf = _flat(p)
            out = torch.where(okr, wn @ pf, pf)
            return out.reshape(p.shape).to(p.dtype)

        return tree_map(leaf, params)

    diag = torch.diagonal(wn)
    wn_od = wn - torch.diag(diag)

    def leaf2(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        pf = _flat(p)
        out = wn_od @ _flat(q) + diag[:, None] * pf
        out = torch.where(okr, out, pf)
        return out.reshape(p.shape).to(p.dtype)

    return tree_map(leaf2, params, pub)


def mix_faulted_csr(
    rows: torch.Tensor,
    cols: torch.Tensor,
    values: torch.Tensor,
    keep: torch.Tensor,
    alive: torch.Tensor,
    n: int,
    params: PyTree,
    pub: PyTree = None,
) -> PyTree:
    """CSR twin of :func:`mix_faulted_dense` (entries sorted by row), summed
    with ``index_add_``. The engine and the fused program mix over the ELL
    view instead (:func:`mix_faulted_ell`: a fixed order, no atomics)."""
    vn, ok = renorm_values(values, keep, rows, n)
    okr = (ok & alive)[:, None]
    rows, cols = rows.long(), cols.long()

    def seg(flat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((n, flat.shape[1]), dtype=flat.dtype, device=flat.device)
        return out.index_add_(0, rows, flat[cols] * v[:, None])

    if pub is None:
        def leaf(p: torch.Tensor) -> torch.Tensor:
            pf = _flat(p)
            out = torch.where(okr, seg(pf, vn), pf)
            return out.reshape(p.shape).to(p.dtype)

        return tree_map(leaf, params)

    is_diag = rows == cols
    dcoef = torch.zeros(n, dtype=vn.dtype, device=vn.device).index_add_(
        0, rows, torch.where(is_diag, vn, 0.0)
    )
    vn_od = torch.where(is_diag, 0.0, vn)

    def leaf2(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        pf = _flat(p)
        out = seg(_flat(q), vn_od) + dcoef[:, None] * pf
        out = torch.where(okr, out, pf)
        return out.reshape(p.shape).to(p.dtype)

    return tree_map(leaf2, params, pub)


def faulted_ell_coefs(
    val: torch.Tensor, keep: torch.Tensor, alive: torch.Tensor, is_diag: torch.Tensor
) -> tuple[torch.Tensor, ...]:
    """The per-round coefficients of a faulted ELL mix over R rows: ``val``,
    ``keep`` and ``is_diag`` (a slot's source is its own row) are (R, K),
    ``alive`` is (R,). Returns the renormalized weights, the rows that mix
    (``ok & alive``, (R, 1)), each row's self weight and the weights with the
    self slot zeroed."""
    vn, ok = renorm_ell(val, keep)
    okr = (ok & alive)[:, None]
    dcoef = torch.where(is_diag, vn, 0.0).sum(dim=1)
    vn_od = torch.where(is_diag, 0.0, vn)
    return vn, okr, dcoef, vn_od


def faulted_ell_rows(
    idx: torch.Tensor, coefs: tuple[torch.Tensor, ...], cur: torch.Tensor,
    src: torch.Tensor, stale: bool,
) -> torch.Tensor:
    """One faulted ELL mix of R rows in f32: ``cur`` (R, p) are the rows'
    own current params and ``src`` the rows ``idx`` addresses (the
    published snapshots when ``stale``, else the current params). With
    stale publishes the self term comes fresh from ``cur``; rows that do not
    mix pass ``cur`` through bit-unchanged."""
    vn, okr, dcoef, vn_od = coefs
    if stale:
        out = ops.ell_sum(idx, vn_od, src) + dcoef[:, None] * cur
    else:
        out = ops.ell_sum(idx, vn, src)
    return torch.where(okr, out, cur)


def mix_faulted_ell(
    idx: torch.Tensor,
    val: torch.Tensor,
    keep: torch.Tensor,
    alive: torch.Tensor,
    params: PyTree,
    pub: PyTree = None,
) -> PyTree:
    """:func:`mix_faulted_csr` over the ELL view of W: ``idx`` (N, K) int64
    source columns, ``val`` (N, K) f32 weights and ``keep`` (N, K) bool.
    Each row sums its slots in slot order (``core.sparse.mix_ell``'s order);
    padding slots weigh 0 and are kept, so they add exact zeros."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    coefs = faulted_ell_coefs(val, keep, alive, idx == rows)

    if pub is None:
        def leaf(p: torch.Tensor) -> torch.Tensor:
            pf = _flat(p)
            return faulted_ell_rows(idx, coefs, pf, pf, False).reshape(p.shape).to(p.dtype)

        return tree_map(leaf, params)

    def leaf2(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        out = faulted_ell_rows(idx, coefs, _flat(p), _flat(q), True)
        return out.reshape(p.shape).to(p.dtype)

    return tree_map(leaf2, params, pub)


def faulted_dense_w(w, keep, alive) -> np.ndarray:
    """The effective mixing matrix a faulted round applies (test/analysis
    helper): renormalized surviving rows, identity rows for dead nodes and
    for rows that lost all mass."""
    wn, ok = renorm_dense(
        torch.as_tensor(np.asarray(w), dtype=torch.float32),
        torch.as_tensor(np.asarray(keep), dtype=torch.bool),
    )
    wn = wn.numpy().copy()
    identity = ~(ok.numpy() & np.asarray(alive, bool))
    wn[identity] = 0.0
    wn[identity, np.flatnonzero(identity)] = 1.0
    return wn


def init_history(params: PyTree, depth: int) -> PyTree:
    """Zeroed ring buffer of past params: each leaf (N, ...) -> (N, depth, ...).

    Node-first layout. Zero-init is safe: reads clamp the effective delay to
    ``min(delay, round)``, so unwritten slots are never consumed.
    """
    return tree_map(
        lambda p: torch.zeros((p.shape[0], depth) + tuple(p.shape[1:]), dtype=p.dtype,
                              device=p.device),
        params,
    )


def _round_tensor(r, device: torch.device) -> torch.Tensor:
    """``r`` as a (1,) int64 tensor on ``device``. A tensor stays the same
    buffer, so a captured graph reads whatever round it holds at replay."""
    if isinstance(r, torch.Tensor):
        return r.reshape(1)
    return torch.tensor([int(r)], dtype=torch.int64, device=device)


def push(params: PyTree, hist: PyTree, r) -> None:
    """Write this round's params into slot ``r % depth`` of ``hist``, in
    place. ``r`` is an int or an int64 tensor on the device."""
    for h, p in zip(tree_leaves(hist), tree_leaves(params)):
        slot = _round_tensor(r, h.device) % h.shape[1]
        h.index_copy_(1, slot, p.unsqueeze(1).to(h.dtype))


def publish(hist: PyTree, r, delay: torch.Tensor) -> PyTree:
    """The snapshots each node publishes at round ``r``: node i reads slot
    ``(r - min(delay_i, r)) % depth`` (its params ``delay_i`` rounds ago,
    clamped to round 0). ``delay`` is (N,) int on the device."""

    def read(h: torch.Tensor) -> torch.Tensor:
        rt = _round_tensor(r, h.device)
        slot = (rt - torch.minimum(delay.long(), rt)) % h.shape[1]
        return h[torch.arange(h.shape[0], device=h.device), slot]

    return tree_map(read, hist)


def push_and_publish(
    params: PyTree, hist: PyTree, r, delay: torch.Tensor
) -> tuple[PyTree, PyTree]:
    """Write this round's params into the ring buffer, read stale snapshots.

    ``hist`` leaves are (N, D, ...) with ``D = delay_max + 1``, enough depth
    that a slot is never overwritten before its last reader; delay-0 nodes
    read the slot just written, so they publish bit-fresh params. Unlike the
    reference's pure function, ``hist`` is updated in place (it is a static
    buffer of a captured round); it is returned for the same call shape.
    """
    push(params, hist, r)
    return publish(hist, r, delay), hist


def _node_mask(alive: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return alive.reshape((-1,) + (1,) * (a.dim() - 1))


def where_alive(alive: torch.Tensor, new: PyTree, old: PyTree) -> PyTree:
    """Per-node select over node-stacked trees: dead nodes keep ``old``."""
    return tree_map(lambda a, b: torch.where(_node_mask(alive, a), a, b), new, old)


def where_alive_stacked(alive: torch.Tensor, new: PyTree, old: PyTree) -> PyTree:
    """``where_alive`` for trees mixing node-stacked leaves with shared
    state: leaves without a leading node axis (a global step count, say)
    pass through unfrozen."""
    n = alive.shape[0]
    return tree_map(
        lambda a, b: a if a.dim() == 0 or a.shape[0] != n
        else torch.where(_node_mask(alive, a), a, b),
        new,
        old,
    )


# ---------------------------------------------------------------------------
# Analytics helpers (host side)
# ---------------------------------------------------------------------------


def churn_rounds(alive_counts: np.ndarray | list[int], n: int) -> list[int]:
    """Rounds where the alive count strictly dropped (churn events)."""
    counts = np.asarray(alive_counts, np.int64)
    prev = np.concatenate([[n], counts[:-1]])
    return np.flatnonzero(counts < prev).tolist()


def recovery_rounds(
    eval_rounds: list[int],
    accs: list[float | None],
    event_round: int,
) -> int | None:
    """Rounds until accuracy recovers to its best pre-event level.

    Over a (round, acc) eval curve: take the max acc strictly before
    ``event_round``; return ``first eval round >= event_round with
    acc >= that max (minus epsilon)`` minus ``event_round``. ``None`` if
    there is no pre-event eval or the run never recovers.
    """
    pre = [a for r, a in zip(eval_rounds, accs) if r < event_round and a is not None]
    if not pre:
        return None
    target = max(pre) - 1e-9
    for r, a in zip(eval_rounds, accs):
        if r >= event_round and a is not None and a >= target:
            return r - event_round
    return None
