"""Sparse (CSR) gossip mixing: the large-N DecAvg path.

A gossip matrix W over a sparse collaboration graph has nnz = 2E + N entries
(neighbours plus self loops), where the dense form has N^2. This module
keeps the reference's layouts and their numpy builders (the same arrays, byte
for byte) and applies one DecAvg round ``out[i] = sum_e W[i, j_e] P[j_e]``
in two ways, numerically close to ``decavg.mix_dense``:

1. ``mix_sparse``        plain PyTorch over the ELL view of the CSR (each
                         row's entries padded to K slots of weight 0): for
                         k = 0..K-1, gather row ``idx[:, k]`` of P, scale it
                         and add it, in f32. The order is fixed and there are
                         no atomics, so every run on every device gives the
                         same bits, and trailing zero-weight slots add exact
                         zeros (the loop and fused paths stay bit-identical).
                         The reference's ``segment_sum`` would be a CUDA
                         scatter with atomics here.
2. ``mix_sparse_pallas`` the hand-written CUDA kernels
                         (``kernels/sparse_gossip.py``): the 8-row-blocked
                         ELL kernel (``blocked=True``) or the scalar ELL row
                         gather. The name is the reference's.

The layouts are host numpy arrays (the reference's are device arrays): the
engine and the fused program move the ELL views they mix with to the device
once per schedule period.

``ShardedCSR``, ``shard_csr``, ``stack_shard_csr`` and ``halo_wire_bytes``
come with the sharded backends (slice F).
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


def _ell_sum(idx: torch.Tensor, val: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """sum_k val[:, k] * flat[idx[:, k]] in k order; ``flat`` is f32."""
    out = flat.index_select(0, idx[:, 0]).mul_(val[:, :1])
    for k in range(1, idx.shape[1]):
        out.add_(flat.index_select(0, idx[:, k]).mul_(val[:, k : k + 1]))
    return out


def mix_ell(
    idx: torch.Tensor, val: torch.Tensor, params: PyTree, *, p_chunk: int | None = None
) -> PyTree:
    """One DecAvg round with W in ELL form (device tensors: ``idx`` (N, K)
    int64, ``val`` (N, K) f32), f32 accumulation in a fixed slot order.

    ``p_chunk`` splits the feature axis so the transient gather buffer is
    O(N * p_chunk) instead of O(N * P) per leaf (each column's sum is the
    same either way).
    """
    n = idx.shape[0]

    def leaf_mix(leaf: torch.Tensor) -> torch.Tensor:
        if leaf.shape[0] != n:
            raise ValueError(f"leaf leading axis {leaf.shape[0]} != num_nodes {n}")
        flat = leaf.reshape(n, -1).float()
        p = flat.shape[1]
        if p_chunk is not None and p_chunk < p:
            out = torch.cat(
                [_ell_sum(idx, val, flat[:, c : c + p_chunk]) for c in range(0, p, p_chunk)],
                dim=1,
            )
        else:
            out = _ell_sum(idx, val, flat)
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
