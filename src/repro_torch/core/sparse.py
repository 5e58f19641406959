"""Sparse (CSR) gossip mixing: the large-N DecAvg path.

A gossip matrix W over a sparse collaboration graph has nnz = 2E + N entries
(neighbours plus self loops), where the dense form has N^2. This module
keeps the reference's layouts and their numpy builders (the same arrays, byte
for byte) and applies one DecAvg round ``out[i] = sum_e W[i, j_e] P[j_e]``
in two ways, numerically close to ``decavg.mix_dense``:

1. ``mix_sparse``        the ELL view of the CSR (each row's entries
                         padded to K slots of weight 0): for k = 0..K-1,
                         gather row ``idx[:, k]`` of P, scale it and add it,
                         in f32 (``kernels/ell_sum.py``: one launch of a
                         hand-written kernel on the card, plain PyTorch on
                         the CPU, the same bits). The order is fixed and
                         there are no atomics, so every run on every device
                         gives the same bits, and zero-weight slots add
                         nothing (the loop and fused paths stay
                         bit-identical). The reference's ``segment_sum``
                         would be a CUDA scatter with atomics here.
2. ``mix_sparse_pallas`` the hand-written CUDA kernels
                         (``kernels/sparse_gossip.py``): the 8-row-blocked
                         ELL kernel (``blocked=True``) or the scalar ELL row
                         gather. The name is the reference's.

The layouts are host numpy arrays (the reference's are device arrays): the
engine and the fused program move the ELL views they mix with to the device
once per schedule period.

The node-sharded layout (``ShardedCSR``, ``shard_csr``, ``stack_shard_csr``,
``halo_wire_bytes``) is the reference's, array for array. The port sums a
shard's rows over its own ELL view (``shard_ell``, on the device as
``ShardedELL``): the shard's slice of the global ELL rows with halo-local
columns, so ``decavg.mix_sharded_sparse`` adds the same products in the same
order as ``mix_ell`` and gives the same bits for any shard count.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_map

__all__ = [
    "CSR",
    "BlockELL",
    "csr_from_dense",
    "csr_from_graph",
    "csr_to_dense",
    "ell_from_csr",
    "block_ell_from_csr",
    "stack_block_ell",
    "mix_ell",
    "mix_sparse",
    "mix_sparse_pallas",
    "auto_p_chunk",
    "ShardedCSR",
    "shard_csr",
    "stack_shard_csr",
    "halo_wire_bytes",
    "shard_ell",
    "ShardedELL",
    "ShardView",
]

PyTree = Any


@dataclasses.dataclass(frozen=True)
class CSR:
    """Row-compressed sparse matrix with precomputed COO row ids.

    Attributes:
      indptr:  (N+1,) int32 — row i spans entries indptr[i]:indptr[i+1].
      indices: (nnz,) int32 — column (source node) of each entry.
      rows:    (nnz,) int32 — row (destination node) of each entry, sorted.
      values:  (nnz,) float32 — W entries.
      shape:   (N, N).
    """

    indptr: np.ndarray
    indices: np.ndarray
    rows: np.ndarray
    values: np.ndarray
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def nbytes(self) -> int:
        """Bytes of the W representation (the O(E) vs O(N^2) claim)."""
        return sum(a.nbytes for a in (self.indptr, self.indices, self.rows, self.values))

    @property
    def max_row_nnz(self) -> int:
        ptr = self.indptr
        return int((ptr[1:] - ptr[:-1]).max()) if self.shape[0] else 0


def csr_from_dense(w: np.ndarray | torch.Tensor, *, tol: float = 0.0) -> CSR:
    """Compress a dense (N, N) mixing matrix; entries with |w| <= tol drop."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    wd = np.asarray(w, dtype=np.float32)
    if wd.ndim != 2 or wd.shape[0] != wd.shape[1]:
        raise ValueError(f"mixing matrix must be square, got {wd.shape}")
    mask = np.abs(wd) > tol
    rows, cols = np.nonzero(mask)  # row-major order -> rows sorted ascending
    indptr = np.zeros(wd.shape[0] + 1, dtype=np.int32)
    np.cumsum(mask.sum(axis=1), out=indptr[1:])
    return CSR(
        indptr=indptr,
        indices=cols.astype(np.int32),
        rows=rows.astype(np.int32),
        values=wd[rows, cols],
        shape=wd.shape,
    )


def csr_from_graph(
    g,
    data_sizes: np.ndarray | None = None,
    *,
    matrix: str = "decavg",
    self_trust: float = 1.0,
) -> CSR:
    """Build the mixing-matrix CSR straight from a graph's edge list.

    The same support as ``csr_from_dense(mixing.decavg_matrix(g, sizes))``
    (and the uniform and mh matrices), values equal to f32 rounding, without
    materializing the dense (N, N) matrix. ``matrix``: "decavg" (paper Eq. 1:
    weights omega * |D_j|, row-normalized; an isolated zero-data row keeps
    its own model), "uniform" (closed-neighbourhood mean) or "mh"
    (Metropolis-Hastings). Exact zeros are dropped; entries come out
    row-major sorted.
    """
    n = g.num_nodes
    if matrix == "mh":
        deg = g.adj.sum(axis=1).astype(np.float64)
        rr, cc = np.nonzero(g.adj)  # off-diagonal edges, no self loops
        off = 1.0 / (1.0 + np.maximum(deg[rr], deg[cc]))
        diag = 1.0 - np.bincount(rr, weights=off, minlength=n)
        rows = np.concatenate([rr, np.arange(n)])
        cols = np.concatenate([cc, np.arange(n)])
        vals = np.concatenate([off, diag])
    else:
        closed = g.adj.copy()
        np.fill_diagonal(closed, True)
        rows, cols = np.nonzero(closed)  # row-major: rows sorted ascending
        if matrix == "uniform":
            inv = 1.0 / np.bincount(rows, minlength=n).astype(np.float64)
            vals = inv[rows]
        elif matrix == "decavg":
            sizes = (
                np.ones(n) if data_sizes is None
                else np.asarray(data_sizes, dtype=np.float64)
            )
            if sizes.shape != (n,):
                raise ValueError(f"data_sizes must be ({n},), got {sizes.shape}")
            omega = np.where(rows == cols, float(self_trust), 1.0)
            vals = omega * sizes[cols]
            rowsum = np.bincount(rows, weights=vals, minlength=n)
            bad = rowsum == 0
            if bad.any():
                # Isolated node with zero data: keep its own model unchanged.
                vals = np.where(bad[rows], np.where(rows == cols, 1.0, 0.0), vals)
                rowsum = np.where(bad, 1.0, rowsum)
            vals = vals / rowsum[rows]
        else:
            raise ValueError(f"matrix must be 'decavg', 'uniform' or 'mh', got {matrix!r}")
    keep = vals != 0.0  # match csr_from_dense's |w| > 0 support
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    order = np.lexsort((cols, rows))  # mh appends the diagonal out of order
    rows = rows[order].astype(np.int32)
    cols = cols[order].astype(np.int32)
    vals = vals[order].astype(np.float32)
    indptr = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return CSR(indptr=indptr, indices=cols, rows=rows, values=vals, shape=(n, n))


def csr_to_dense(csr: CSR) -> np.ndarray:
    out = np.zeros(csr.shape, dtype=np.float32)
    out[csr.rows, csr.indices] = csr.values
    return out


def ell_from_csr(csr: CSR) -> tuple[np.ndarray, np.ndarray]:
    """ELL padding: (N, K) column indices and values, K = max row nnz.
    Padding slots point at column 0 with weight 0."""
    n = csr.shape[0]
    k = max(csr.max_row_nnz, 1)
    idx = np.zeros((n, k), dtype=np.int32)
    val = np.zeros((n, k), dtype=np.float32)
    ptr = csr.indptr
    for i in range(n):
        lo, hi = int(ptr[i]), int(ptr[i + 1])
        idx[i, : hi - lo] = csr.indices[lo:hi]
        val[i, : hi - lo] = csr.values[lo:hi]
    return idx, val


@dataclasses.dataclass(frozen=True)
class BlockELL:
    """The reference's 8-row-blocked ELL layout.

    Rows are grouped into blocks of ``block``; for each destination block the
    distinct source blocks touched by any of its rows are enumerated, and the
    weights coupling the two blocks are stored as a dense (block, block)
    tile.

    Attributes:
      idx: (NB, KB) int32 — source block ids per destination block, padded
           with 0 (their weight tiles are all zero).
      val: (NB*block, KB*block) f32 — ``val[r, t*block + o]`` is the weight
           of global row r against row ``idx[r//block, t]*block + o``. KB is
           padded to a multiple of ``lane_pad`` (the TPU's lane alignment;
           the CUDA kernel skips the all-zero tiles).
      n:   unpadded row count; block: rows per block.
    """

    idx: np.ndarray
    val: np.ndarray
    n: int
    block: int = 8

    @property
    def num_blocks(self) -> int:
        return int(self.idx.shape[0])

    @property
    def max_blocks_per_row(self) -> int:
        return int(self.idx.shape[1])


def block_ell_from_csr(csr: CSR, *, block: int = 8, lane_pad: int = 16) -> BlockELL:
    """Build the 8-row-blocked ELL layout (see BlockELL) from a CSR matrix."""
    n = csr.shape[0]
    nb = -(-n // block)
    ptr, cols, vals = csr.indptr, csr.indices, csr.values
    slots: list[dict[int, int]] = []
    entries: list[list[tuple[int, int, float]]] = []  # (row, val-col, value)
    for b in range(nb):
        slot: dict[int, int] = {}
        ent: list[tuple[int, int, float]] = []
        for r in range(b * block, min((b + 1) * block, n)):
            for e in range(int(ptr[r]), int(ptr[r + 1])):
                sb, off = divmod(int(cols[e]), block)
                t = slot.setdefault(sb, len(slot))
                ent.append((r, t * block + off, float(vals[e])))
        slots.append(slot)
        entries.append(ent)

    kb = max(max((len(s) for s in slots), default=0), 1)
    kb = -(-kb // lane_pad) * lane_pad
    idx = np.zeros((nb, kb), dtype=np.int32)
    val = np.zeros((nb * block, kb * block), dtype=np.float32)
    for b, (slot, ent) in enumerate(zip(slots, entries)):
        for sb, t in slot.items():
            idx[b, t] = sb
        for r, c, v in ent:
            val[r, c] = v
    return BlockELL(idx=idx, val=val, n=n, block=block)


def stack_block_ell(
    csrs: list[CSR], *, block: int = 8, lane_pad: int = 16
) -> tuple[np.ndarray, np.ndarray]:
    """Blocked-ELL layouts for every schedule period, padded with all-zero
    index-0 tiles to a common block count and stacked on a leading period
    axis: ``idx`` (T, NB, KB) int32 and ``val`` (T, NB*block, KB*block) f32."""
    if not csrs:
        raise ValueError("need at least one period")
    if any(c.shape != csrs[0].shape for c in csrs):
        raise ValueError("all periods must share the matrix shape")
    bells = [block_ell_from_csr(c, block=block, lane_pad=lane_pad) for c in csrs]
    kb = max(b.max_blocks_per_row for b in bells)
    idx = np.stack([np.pad(b.idx, ((0, 0), (0, kb - b.idx.shape[1]))) for b in bells])
    val = np.stack(
        [np.pad(b.val, ((0, 0), (0, (kb - b.idx.shape[1]) * block))) for b in bells]
    )
    return idx, val


def mix_ell(
    idx: torch.Tensor, val: torch.Tensor, params: PyTree, *, p_chunk: int | None = None
) -> PyTree:
    """One DecAvg round with W in ELL form (device tensors: ``idx`` (N, K)
    int64, ``val`` (N, K) f32), f32 accumulation in a fixed slot order.

    ``p_chunk`` splits the feature axis so the plain version's transient
    gather buffer is O(N * p_chunk) instead of O(N * P) per leaf (each
    column's sum is the same either way). It applies to CPU tensors only:
    on the card each leaf is one launch of the ELL sum kernel over its whole
    width, which allocates no gather buffer.
    """
    n = idx.shape[0]

    def leaf_mix(leaf: torch.Tensor) -> torch.Tensor:
        if leaf.shape[0] != n:
            raise ValueError(f"leaf leading axis {leaf.shape[0]} != num_nodes {n}")
        flat = leaf.reshape(n, -1).float()
        p = flat.shape[1]
        if p_chunk is not None and p_chunk < p and flat.device.type == "cpu":
            out = torch.cat(
                [ops.ell_sum(idx, val, flat[:, c : c + p_chunk]) for c in range(0, p, p_chunk)],
                dim=1,
            )
        else:
            out = ops.ell_sum(idx, val, flat)
        return out.reshape(leaf.shape).to(leaf.dtype)

    return tree_map(leaf_mix, params)


def _device_of(params: PyTree) -> torch.device:
    return tree_leaves(params)[0].device


def mix_sparse(csr: CSR, params: PyTree, *, p_chunk: int | None = None) -> PyTree:
    """One DecAvg round ``P <- W @ P`` with W in CSR, O(E * P) work.

    ``p_chunk`` bounds the transient gather buffer per leaf (see ``mix_ell``).
    """
    idx, val = ell_from_csr(csr)
    dev = _device_of(params)
    return mix_ell(
        torch.as_tensor(idx, dtype=torch.int64, device=dev),
        torch.as_tensor(val, device=dev),
        params,
        p_chunk=p_chunk,
    )


def auto_p_chunk(nnz: int, budget_elems: int = 1 << 22) -> int:
    """Feature-axis chunk size keeping the gather buffer under ``budget_elems``
    f32 elements (default 4M ~= 16 MiB)."""
    return max(64, budget_elems // max(nnz, 1))


def mix_kernel(fn, idx: torch.Tensor, val: torch.Tensor, params: PyTree) -> PyTree:
    """Apply a sparse kernel wrapper ``fn(idx, val, P)`` per flattened leaf."""

    def leaf_mix(leaf: torch.Tensor) -> torch.Tensor:
        return fn(idx, val, leaf.reshape(leaf.shape[0], -1)).reshape(leaf.shape)

    return tree_map(leaf_mix, params)


def mix_sparse_pallas(
    csr: CSR,
    params: PyTree,
    *,
    ell: tuple[np.ndarray, np.ndarray] | None = None,
    bell: BlockELL | None = None,
    blocked: bool | None = None,
) -> PyTree:
    """Sparse DecAvg round via the CUDA ELL kernels.

    ``blocked``: the 8-row-blocked ELL kernel (True) or the scalar ELL row
    gather (False). None means blocked on CUDA tensors, as on the TPU, and
    the scalar kernel's plain version on CPU tensors, as the reference picks
    the scalar kernel off the TPU. ``ell`` / ``bell`` pass a precomputed
    layout instead of building it from ``csr``.
    """
    dev = _device_of(params)
    if blocked is None:
        blocked = dev.type == "cuda"
    if blocked:
        b = block_ell_from_csr(csr) if bell is None else bell
        fn, idx, val = ops.gossip_mix_sparse_blocked, b.idx, b.val
    else:
        idx, val = ell_from_csr(csr) if ell is None else ell
        fn = ops.gossip_mix_sparse
    return mix_kernel(fn, torch.as_tensor(idx, device=dev), torch.as_tensor(val, device=dev), params)


# ---------------------------------------------------------------------------
# The node-sharded layout (backend "sparse_sharded")
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedCSR:
    """CSR with the node (row) axis split into ``shards`` contiguous ranges.

    Shard ``s`` owns destination rows ``[s*rows_per_shard, (s+1)*rows_per_shard)``
    and stores its W entries with *halo-local* column ids: ``halo[s]`` lists
    the global source nodes shard ``s`` needs (its own rows plus cross-shard
    neighbors), and ``cols`` indexes into that halo list. One sharded round
    (``decavg.mix_sharded_sparse``) assembles the shard's halo rows of P into
    an (H, p) buffer and sums the shard's entries over it.

    Two halo assembly schedules use the same layout:

    - allgather: gather the full node axis once, take the ``halo[s]`` rows.
    - ring: S-1 ``ppermute`` steps; at step d every shard sends exactly the
      rows shard ``(s+d) % S`` needs from it (``ring_send[d-1]``) and places
      what it receives from shard ``(s-d) % S`` at the matching halo slots
      (``ring_recv[d-1]``); its own rows are copied locally via
      ``local_src``/``local_dst``. Steps in which no shard pair exchanges
      anything have zero-width index arrays and are skipped.

    All per-shard arrays are stacked on a leading shard axis and zero-padded
    to the largest shard: padded entries weigh 0 and point at halo slot 0 and
    the shard's last local row; padded ring/local *destination* slots point
    at the scratch slot H (one past the halo), which the mix discards.

    Attributes (host numpy arrays, the reference's byte for byte):
      halo:   (S, H) int32 -- global source ids needed by shard s (sorted,
              padded by repeating id 0).
      rows:   (S, E) int32 -- destination row LOCAL to the shard, sorted
              (padded with rows_per_shard - 1).
      cols:   (S, E) int32 -- index into ``halo[s]`` (padded with 0).
      values: (S, E) float32 -- W entries (padded with 0).
      local_src: (S, L) int32 -- shard-local rows copied into the halo
              buffer without communication (padded with 0).
      local_dst: (S, L) int32 -- their halo slots (padded with H).
      ring_send: tuple of (S, K_d) int32, one per ring step d=1..S-1 --
              rows LOCAL to the sending shard, in the receiver's halo order.
      ring_recv: tuple of (S, K_d) int32 -- halo slots where the rows
              received at step d land (padded with H).
      shape: (N, N); shards, rows_per_shard: ints.
    """

    halo: np.ndarray
    rows: np.ndarray
    cols: np.ndarray
    values: np.ndarray
    local_src: np.ndarray
    local_dst: np.ndarray
    ring_send: tuple[np.ndarray, ...]
    ring_recv: tuple[np.ndarray, ...]
    shape: tuple[int, int]
    shards: int
    rows_per_shard: int

    @property
    def halo_width(self) -> int:
        """Max rows of P any shard gathers (the halo buffer height)."""
        return int(self.halo.shape[1])

    @property
    def ring_width(self) -> int:
        """Rows of P one shard receives a round under the ring schedule
        (the sum of the padded per-step widths: the O(H) wire bound)."""
        return sum(int(a.shape[1]) for a in self.ring_send)

    @property
    def nbytes(self) -> int:
        return sum(
            a.nbytes
            for a in (
                self.halo, self.rows, self.cols, self.values,
                self.local_src, self.local_dst, *self.ring_send, *self.ring_recv,
            )
        )


def shard_csr(csr: CSR, shards: int) -> ShardedCSR:
    """Split a CSR mixing matrix into per-shard row ranges with halo columns,
    and derive the ring's peer metadata (see ``ShardedCSR``). Needs N
    divisible by ``shards``. Host-side, once per schedule period."""
    n = csr.shape[0]
    if shards < 1 or n % shards:
        raise ValueError(f"num_nodes {n} not divisible by shards {shards}")
    blk = n // shards
    ptr, cols, vals, coo_rows = csr.indptr, csr.indices, csr.values, csr.rows

    halos: list[np.ndarray] = []
    loc_rows: list[np.ndarray] = []
    loc_cols: list[np.ndarray] = []
    loc_vals: list[np.ndarray] = []
    for s in range(shards):
        lo, hi = int(ptr[s * blk]), int(ptr[(s + 1) * blk])
        c = cols[lo:hi]
        need = np.unique(c)  # the shard's halo: sorted global sources
        if need.size == 0:
            need = np.zeros(1, dtype=np.int32)
        halos.append(need.astype(np.int32))
        loc_rows.append((coo_rows[lo:hi] - s * blk).astype(np.int32))
        loc_cols.append(np.searchsorted(need, c).astype(np.int32))
        loc_vals.append(vals[lo:hi].astype(np.float32))

    h_max = max(h.size for h in halos)
    e_max = max(max(r.size for r in loc_rows), 1)
    halo = np.zeros((shards, h_max), dtype=np.int32)
    rows = np.full((shards, e_max), blk - 1, dtype=np.int32)
    lcols = np.zeros((shards, e_max), dtype=np.int32)
    lvals = np.zeros((shards, e_max), dtype=np.float32)
    for s in range(shards):
        halo[s, : halos[s].size] = halos[s]
        k = loc_rows[s].size
        rows[s, :k] = loc_rows[s]
        lcols[s, :k] = loc_cols[s]
        lvals[s, :k] = loc_vals[s]

    # Ring peers: at step d shard s receives its halo rows owned by
    # (s - d) % shards, packed in halo order, and sends the rows
    # (s + d) % shards needs from it in that receiver's halo order.
    scratch = h_max
    loc_src = [np.flatnonzero(halos[s] // blk == s) for s in range(shards)]
    l_max = max(max((p.size for p in loc_src), default=0), 1)
    local_src = np.zeros((shards, l_max), dtype=np.int32)
    local_dst = np.full((shards, l_max), scratch, dtype=np.int32)
    for s in range(shards):
        p = loc_src[s]
        local_src[s, : p.size] = halos[s][p] - s * blk
        local_dst[s, : p.size] = p

    ring_send: list[np.ndarray] = []
    ring_recv: list[np.ndarray] = []
    for d in range(1, shards):
        recv_pos = [
            np.flatnonzero(halos[r] // blk == (r - d) % shards) for r in range(shards)
        ]
        k_d = max(p.size for p in recv_pos)
        send = np.zeros((shards, k_d), dtype=np.int32)
        recv = np.full((shards, k_d), scratch, dtype=np.int32)
        for r in range(shards):
            o = (r - d) % shards
            p = recv_pos[r]
            send[o, : p.size] = halos[r][p] - o * blk
            recv[r, : p.size] = p
        ring_send.append(send)
        ring_recv.append(recv)

    return ShardedCSR(
        halo=halo, rows=rows, cols=lcols, values=lvals,
        local_src=local_src, local_dst=local_dst,
        ring_send=tuple(ring_send), ring_recv=tuple(ring_recv),
        shape=csr.shape, shards=shards, rows_per_shard=blk,
    )


def stack_shard_csr(shcsrs: list[ShardedCSR]) -> dict[str, Any]:
    """Pad per-period ShardedCSRs to common widths and stack them on a
    period axis, as the reference does for its fused scan.

    The halo pads to the widest period's by repeating id 0 (rows never
    referenced), entries pad with zero-weight entries at the shard's last
    local row, ring/local tables pad per step to the widest step. A ring
    step stays zero-width only if it is zero-width in every period. Each
    period's own scratch slot (its halo width) is remapped to the stacked
    scratch ``h_max``, so padded writes still land one past the halo.

    Returns halo/rows/cols/values/local_src/local_dst as (T, S, ...) arrays
    and ring_send/ring_recv as tuples of (T, S, K_d) arrays.
    """
    s0 = shcsrs[0]
    if any(s.shards != s0.shards or s.shape != s0.shape for s in shcsrs):
        raise ValueError("all periods must share shape and shard count")
    h_max = max(s.halo_width for s in shcsrs)
    e_max = max(int(s.rows.shape[1]) for s in shcsrs)
    l_max = max(int(s.local_src.shape[1]) for s in shcsrs)
    steps = s0.shards - 1
    k_max = [max(int(s.ring_send[d].shape[1]) for s in shcsrs) for d in range(steps)]

    def pad(a: np.ndarray, width: int, fill) -> np.ndarray:
        return np.pad(a, ((0, 0), (0, width - a.shape[1])), constant_values=fill)

    def remap_scratch(a: np.ndarray, s: ShardedCSR) -> np.ndarray:
        return np.where(a == s.halo_width, h_max, a).astype(a.dtype)

    return {
        "halo": np.stack([pad(s.halo, h_max, 0) for s in shcsrs]),
        "rows": np.stack([pad(s.rows, e_max, s0.rows_per_shard - 1) for s in shcsrs]),
        "cols": np.stack([pad(s.cols, e_max, 0) for s in shcsrs]),
        "values": np.stack([pad(s.values, e_max, 0.0) for s in shcsrs]),
        "local_src": np.stack([pad(s.local_src, l_max, 0) for s in shcsrs]),
        "local_dst": np.stack(
            [pad(remap_scratch(s.local_dst, s), l_max, h_max) for s in shcsrs]
        ),
        "ring_send": tuple(
            np.stack([pad(s.ring_send[d], k_max[d], 0) for s in shcsrs])
            for d in range(steps)
        ),
        "ring_recv": tuple(
            np.stack([pad(remap_scratch(s.ring_recv[d], s), k_max[d], h_max) for s in shcsrs])
            for d in range(steps)
        ),
    }


def halo_wire_bytes(shcsr: ShardedCSR, p: int, *, itemsize: int = 4) -> dict[str, int]:
    """Modeled per-shard *receive* volume of one mixing round, per schedule:
    the allgather brings the other shards' (N - N/S) rows, the ring only the
    padded per-step halo rows (``ring_width``). Payload bytes of P rows at
    ``p`` features; layout metadata is not counted."""
    n = shcsr.shape[0]
    return {
        "allgather": (n - shcsr.rows_per_shard) * p * itemsize,
        "ring": shcsr.ring_width * p * itemsize,
    }


def shard_ell(
    rows: np.ndarray, cols: np.ndarray, values: np.ndarray, rows_per_shard: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, tuple[int, ...]]:
    """Each shard's ELL view of its (S, E) entries (a ``ShardedCSR``'s
    ``rows``/``cols``/``values``, or one period of ``stack_shard_csr``).

    Slot k of a row holds the row's k-th nonzero entry in CSR order, as
    ``ell_from_csr`` does for the whole matrix; zero-weight entries (the
    layout's padding) get no slot. Returns ``idx`` (S, blk, K) int32
    halo-local columns, ``val`` (S, blk, K) f32, ``pos`` (S, blk, K) int32,
    the entry each slot holds (0 for padding slots, which weigh 0), and the
    slots each shard uses (``widths``, at least 1)."""
    shards = rows.shape[0]
    blk = int(rows_per_shard)
    per = []
    for s in range(shards):
        e = np.flatnonzero(values[s] != 0.0)
        r = rows[s, e]
        slot = np.arange(e.size) - np.searchsorted(r, r, side="left")
        per.append((e, r, slot))
    widths = tuple(max(int(slot.max()) + 1 if slot.size else 1, 1) for _, _, slot in per)
    k = max(widths)
    idx = np.zeros((shards, blk, k), np.int32)
    val = np.zeros((shards, blk, k), np.float32)
    pos = np.zeros((shards, blk, k), np.int32)
    for s, (e, r, slot) in enumerate(per):
        idx[s, r, slot] = cols[s, e]
        val[s, r, slot] = values[s, e]
        pos[s, r, slot] = e
    return idx, val, pos, widths


@dataclasses.dataclass(frozen=True)
class ShardedELL:
    """One period's sharded layout on the device, as the port mixes it.

    The halo and ring tables of a ``ShardedCSR`` (int64), and each shard's
    ELL view of its entries (``shard_ell``): ``idx`` (S, blk, K) halo-local
    columns, ``val`` (S, blk, K) f32 and ``pos`` (S, blk, K), the entry of
    the (S, E) layout each slot holds (a faulted round's keep mask comes in
    that layout). ``widths`` are the slots shard s sums (the rest weigh 0).
    Built from a ``ShardedCSR`` (``from_csr``) or as a view of a fused
    program's stacked periods; ``shard_views`` places each shard's part on
    its shard's device."""

    halo: torch.Tensor
    local_src: torch.Tensor
    local_dst: torch.Tensor
    ring_send: tuple[torch.Tensor, ...]
    ring_recv: tuple[torch.Tensor, ...]
    idx: torch.Tensor
    val: torch.Tensor
    pos: torch.Tensor
    widths: tuple[int, ...]
    n: int

    @property
    def shards(self) -> int:
        return int(self.halo.shape[0])

    @property
    def rows_per_shard(self) -> int:
        return self.n // self.shards

    @property
    def halo_width(self) -> int:
        return int(self.halo.shape[1])

    @property
    def ring_width(self) -> int:
        return sum(int(a.shape[1]) for a in self.ring_send)

    @classmethod
    def from_csr(cls, shcsr: ShardedCSR, device: torch.device) -> "ShardedELL":
        idx, val, pos, widths = shard_ell(
            shcsr.rows, shcsr.cols, shcsr.values, shcsr.rows_per_shard
        )

        def dev(a: np.ndarray) -> torch.Tensor:
            return torch.as_tensor(a, dtype=torch.int64, device=device)

        return cls(
            halo=dev(shcsr.halo), local_src=dev(shcsr.local_src),
            local_dst=dev(shcsr.local_dst),
            ring_send=tuple(dev(a) for a in shcsr.ring_send),
            ring_recv=tuple(dev(a) for a in shcsr.ring_recv),
            idx=dev(idx), val=torch.as_tensor(val, device=device), pos=dev(pos),
            widths=widths, n=shcsr.shape[0],
        )

    def shard_views(self, devices: list[torch.device]) -> tuple["ShardView", ...]:
        """Each shard's part of the layout, copied once to its shard's device
        (``devices[s]``), so a round reads it there without a copy."""
        if len(devices) != self.shards:
            raise ValueError(f"layout has {self.shards} shards, got {len(devices)} devices")
        blk = self.rows_per_shard
        dists = tuple(d for d, a in enumerate(self.ring_send, 1) if a.shape[-1])
        views = []
        for s, dev in enumerate(devices):
            w = self.widths[s]
            idx = self.idx[s, :, :w]
            rows = s * blk + torch.arange(blk, device=idx.device)

            def put(a: torch.Tensor, dev=dev) -> torch.Tensor:
                return a.to(dev).contiguous()

            views.append(ShardView(
                shard=s, device=dev, idx=put(idx), val=put(self.val[s, :, :w]),
                pos=put(self.pos[s, :, :w]), is_diag=put(self.halo[s][idx] == rows[:, None]),
                halo=put(self.halo[s]), local_src=put(self.local_src[s]),
                local_dst=put(self.local_dst[s]), ring_dists=dists,
                ring_send=tuple(put(self.ring_send[d - 1][s]) for d in dists),
                ring_recv=tuple(put(self.ring_recv[d - 1][s]) for d in dists),
                n=self.n,
            ))
        return tuple(views)


@dataclasses.dataclass(frozen=True)
class ShardView:
    """Shard ``shard``'s part of a ``ShardedELL``, on its own ``device``.

    ``idx``/``val``/``pos`` (blk, w) are its ELL slots cut to the ``w``
    slots it sums, and ``is_diag`` (blk, w) marks the slots whose source is
    the row itself (a faulted round's self term). ``halo`` (H,) lists the
    global rows its halo buffer holds; ``local_src``/``local_dst`` place its
    own rows in the buffer; at each ring distance that moves rows
    (``ring_dists``) it sends its rows ``ring_send`` to shard ``s + d`` and
    fills slots ``ring_recv`` from shard ``s - d``."""

    shard: int
    device: torch.device
    idx: torch.Tensor
    val: torch.Tensor
    pos: torch.Tensor
    is_diag: torch.Tensor
    halo: torch.Tensor
    local_src: torch.Tensor
    local_dst: torch.Tensor
    ring_dists: tuple[int, ...]
    ring_send: tuple[torch.Tensor, ...]
    ring_recv: tuple[torch.Tensor, ...]
    n: int

    @property
    def rows_per_shard(self) -> int:
        return int(self.idx.shape[0])

    @property
    def halo_width(self) -> int:
        return int(self.halo.shape[0])
