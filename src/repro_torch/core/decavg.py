"""DecAvg: one communication round of decentralized averaging (paper Eq. 1).

All per-node model state is *node-stacked*: every leaf of the parameter tree
carries a leading ``node`` axis of size N. One communication round is the
linear map ``P <- W @ P`` applied leaf-wise, where W is the (N, N)
row-stochastic mixing matrix from core/mixing.py.

The execution paths, numerically equivalent (tests hold them to 3e-5):

1. ``mix_dense``  — ``torch.matmul`` per leaf, accumulating in the leaf dtype
                    (the reference's ``_mix_leaf`` contract). The default
                    below N=512.
2. ``mix_pallas`` — the hand-written CUDA ``gossip_mix`` kernel per
                    flattened leaf (kernels/gossip_mix.py), f32 accumulation.
                    The backend keeps the reference's name ``"pallas"`` so one
                    spec means the same run in both packages.
3. ``sparse``     — W as CSR, mixed over its ELL view in a fixed order
                    (core/sparse.py ``mix_ell``: one launch of the ELL sum
                    kernel a leaf on the card, plain PyTorch on the CPU, the
                    same bits): O(E * P), the default at N >= 512.
4. ``sparse_pallas`` — the CUDA sparse kernels (kernels/sparse_gossip.py):
                    the 8-row-blocked ELL kernel on the card.
5. The node-sharded paths, over a ``core.mesh.Mesh`` of S shards (the
   reference's ``shard_map`` bodies, run per shard in one process):
   ``mix_sharded`` (dense W, "allgather" or "reduce_scatter"),
   ``mix_sharded_sparse`` (per-shard CSR row ranges with compact halos,
   assembled by an "allgather" or a "ring" of ``ppermute`` steps, then the
   shard's rows summed in ``mix_ell``'s order, so it gives the same bits as
   ``sparse`` for any S) and ``mix_permute`` (one ``ppermute`` per edge
   color, one node a shard). Each takes the whole node axis on one device
   and moves the slabs out and back; ``mix_sharded_sparse_slabs`` (and
   ``MixingProgram.apply_local``, ``GossipEngine.mix_slabs``) take and
   give per-shard slabs, each on its shard's device, which is how a
   sharded ``run_fused`` and the LM cohort keep their state sharded end to
   end.

``GossipEngine`` is the front door: it owns the topology (static graph or
TopologySchedule), builds the mixing matrix (and, for the sparse backends,
its CSR) per schedule period, resolves the backend and applies the per-round
gossip cadence. For fused runs, ``GossipEngine.program(rounds)`` stages
every schedule period up front as a ``MixingProgram`` (stacked dense W,
stacked ELL, stacked blocked-ELL tiles or stacked per-shard layouts on the
device), which the trainer's ``run_fused`` replays round by round.

With ``faults=`` (core/faults.py) the engine mixes the faulted round on the
``dense``, ``sparse`` and ``sparse_sharded`` backends, as the reference
does: each row renormalized over its surviving entries, stale snapshots from
stragglers, dead and emptied rows passed through bit-unchanged; ``program()``
then also stages the run's alive and entry-keep masks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import faults as faults_mod
from repro_torch.core import mesh as mesh_mod
from repro_torch.core import mixing, sparse
from repro_torch.core import topology as topo
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = [
    "GossipEngine",
    "MixingProgram",
    "ShardFaults",
    "gossip_error",
    "mix_dense",
    "mix_pallas",
    "mix_sharded",
    "mix_sharded_sparse",
    "mix_sharded_sparse_faulted",
    "mix_sharded_sparse_slabs",
    "mix_sharded_sparse_faulted_slabs",
    "mix_permute",
]

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
# The node-sharded paths: per-shard bodies over a core.mesh.Mesh
# ---------------------------------------------------------------------------


def _shards_of(mesh, node_axis) -> tuple[tuple[str, ...], int, list[torch.device]]:
    axes = mesh_mod.axes_of(node_axis)
    return axes, mesh_mod.axis_size(mesh, axes), mesh.shard_devices(axes)


def _slabs(flat: torch.Tensor, devices: list[torch.device]) -> list[torch.Tensor]:
    """The (n, p) node axis cut into one row block per shard, each on its
    shard's device (a view when it is already there)."""
    blk = flat.shape[0] // len(devices)
    return [flat[s * blk:(s + 1) * blk].to(d) for s, d in enumerate(devices)]


def mix_sharded(
    w: torch.Tensor,
    params: PyTree,
    *,
    mesh,
    node_axis: str | tuple[str, ...] = "data",
    schedule: str = "reduce_scatter",
) -> PyTree:
    """DecAvg round with the node axis split over ``node_axis`` of ``mesh``.

    W is replicated (N^2 floats). Per shard, in f32:

    - allgather: gather the full node axis, multiply the shard's W rows.
    - reduce_scatter: multiply the shard's W columns by its slab (its nodes'
      contributions to everyone), then sum the shards' products and give
      each shard its row block (``psum_scatter``).
    """
    axes, shards, devices = _shards_of(mesh, node_axis)
    n = w.shape[0]
    if n % shards:
        raise ValueError(f"num_nodes {n} not divisible by node shards {shards}")
    if schedule not in ("allgather", "reduce_scatter"):
        raise ValueError(f"schedule must be 'allgather' or 'reduce_scatter', got {schedule!r}")
    blk = n // shards
    wf = w.float()

    def mix_one(leaf: torch.Tensor) -> torch.Tensor:
        if leaf.shape[0] != n:
            raise ValueError(f"leaf leading axis {leaf.shape[0]} != num_nodes {n}")
        slabs = _slabs(leaf.reshape(n, -1).float(), devices)
        if schedule == "allgather":
            outs = [wf[s * blk:(s + 1) * blk].to(d) @ mesh_mod.all_gather(slabs, d, shard=s)
                    for s, d in enumerate(devices)]
        else:
            contribs = [wf[:, s * blk:(s + 1) * blk].to(d) @ slabs[s]
                        for s, d in enumerate(devices)]
            outs = mesh_mod.psum_scatter(contribs, devices)
        out = torch.cat([o.to(leaf.device) for o in outs])
        return out.reshape(leaf.shape).to(leaf.dtype)

    return tree_map(mix_one, params)


def _cat_leaves(tree: PyTree) -> torch.Tensor:
    """A tree's node-stacked leaves as one (n, P_total) f32 matrix, side by
    side in ``tree_leaves`` order."""
    flats = [leaf.reshape(leaf.shape[0], -1).float() for leaf in tree_leaves(tree)]
    return flats[0] if len(flats) == 1 else torch.cat(flats, dim=1)


def _split_leaves(out: torch.Tensor, like: PyTree) -> PyTree:
    """``out`` (n, P_total) cut back into ``like``'s leaves and dtypes."""
    leaves = tree_leaves(like)
    outs = out.split([leaf[0].numel() for leaf in leaves], dim=1)
    return tree_unflatten(like, [o.reshape(l.shape).to(l.dtype) for o, l in zip(outs, leaves)])


def _mix_leaves_concatenated(params: PyTree, n: int, mix_cat, *more: PyTree) -> PyTree:
    """Run ``mix_cat`` once on all leaves' features side by side.

    Mixing is linear over the node axis and columns are independent, so one
    (n, P_total) f32 matrix mixes to the same bits as the leaves one by one,
    while the halo exchange runs once a round instead of once a leaf. Trees
    in ``more`` laid out like ``params`` (the faulted round's published
    snapshots) are concatenated alike and passed after it."""
    for leaf in tree_leaves(params):
        if leaf.shape[0] != n:
            raise ValueError(f"leaf leading axis {leaf.shape[0]} != num_nodes {n}")
    return _split_leaves(mix_cat(_cat_leaves(params), *(_cat_leaves(t) for t in more)), params)


def _resolve_ring(view: sparse.ShardView, halo_schedule: str) -> bool:
    """True for the ring: ``auto`` takes it when its wire (the ring steps'
    rows) undercuts the allgather's N - N/S."""
    if halo_schedule == "auto":
        ring_width = sum(int(a.shape[0]) for a in view.ring_send)
        return ring_width < view.n - view.rows_per_shard
    if halo_schedule not in ("allgather", "ring"):
        raise ValueError(
            f"halo_schedule must be 'allgather', 'ring' or 'auto', got {halo_schedule!r}"
        )
    return halo_schedule == "ring"


# The per-shard pieces of a sharded sparse round, the counterpart of the
# reference's ``_sharded_mix_leaf``: each shard's sends and rows are
# computed on its own device from its own (blk, p) slab, and the exchange
# between them is the only code that moves data from one shard to another.


def _halo_sends(view: sparse.ShardView, src: torch.Tensor, ring: bool) -> list[torch.Tensor]:
    """What one shard sends in a round's halo exchange: under the ring, the
    (K_d, p) rows its peer at each distance needs; under the allgather, its
    whole slab."""
    if not ring:
        return [src]
    return [src.index_select(0, send) for send in view.ring_send]


def _halo_exchange(sends: list[list[torch.Tensor]], devices: list[torch.device],
                   views: tuple[sparse.ShardView, ...], ring: bool) -> list[list[torch.Tensor]]:
    """Every shard's ``_halo_sends`` through ``core.mesh``'s collectives:
    what each shard receives, one block a ring distance (from shard s - d)
    or, under the allgather, the full node axis."""
    shards = len(devices)
    if not ring:
        slabs = [x[0] for x in sends]
        return [[mesh_mod.all_gather(slabs, d, shard=s)] for s, d in enumerate(devices)]
    got: list[list[torch.Tensor]] = [[] for _ in range(shards)]
    for k, dist in enumerate(views[0].ring_dists):
        moved = mesh_mod.ppermute([x[k] for x in sends],
                                  [(s, (s + dist) % shards) for s in range(shards)], devices)
        for s in range(shards):
            got[s].append(moved[s])
    return got


def _halo_buffer(view: sparse.ShardView, src: torch.Tensor, got: list[torch.Tensor],
                 ring: bool) -> torch.Tensor:
    """One shard's (H, p) halo buffer: the rows of P its entries reference,
    in halo order. ring: its own rows copied locally, the received rows at
    their slots, in a buffer with one scratch row at slot H for padded
    destinations, dropped at the end. allgather: its halo rows of the
    gathered node axis."""
    if not ring:
        return got[0].index_select(0, view.halo)
    h = view.halo_width
    buf = src.new_zeros((h + 1, src.shape[1]))
    buf[view.local_dst] = src.index_select(0, view.local_src)
    for recv, rows in zip(view.ring_recv, got):
        buf[recv] = rows
    return buf[:h]


def _shard_rows(view: sparse.ShardView, buf: torch.Tensor, p_chunk: int | None) -> torch.Tensor:
    """One shard's rows: its ELL slots summed over its halo buffer in slot
    order (``kernels.ops.ell_sum``). On the CPU in ``p_chunk`` column slabs when
    set, which bound the plain version's gather buffer; on the card one
    launch of the ELL sum kernel over the whole width, which needs none."""
    p = buf.shape[1]
    if p_chunk is not None and p_chunk < p and buf.device.type == "cpu":
        return torch.cat([ops.ell_sum(view.idx, view.val, buf[:, c:c + p_chunk])
                          for c in range(0, p, p_chunk)], dim=1)
    return ops.ell_sum(view.idx, view.val, buf)


def _shard_rows_faulted(view: sparse.ShardView, buf: torch.Tensor, cur: torch.Tensor,
                        keep: torch.Tensor, alive: torch.Tensor, stale: bool) -> torch.Tensor:
    """One shard's faulted rows, ``faults.mix_faulted_ell``'s on them:
    ``keep`` is its (E,) entry mask, ``alive`` its (blk,) nodes' and ``cur``
    their (blk, p) current params; ``stale`` when ``buf`` holds published
    snapshots."""
    k = keep[view.pos.reshape(-1)].reshape(view.pos.shape)
    coefs = faults_mod.faulted_ell_coefs(view.val, k, alive, view.is_diag)
    return faults_mod.faulted_ell_rows(view.idx, coefs, cur, buf, stale)


def _views_of(shcsr, devices: list[torch.device], axes) -> tuple[sparse.ShardView, ...]:
    """Per-shard views on ``devices`` of a ``ShardedCSR``, a ``ShardedELL``
    or views already staged."""
    if isinstance(shcsr, sparse.ShardedCSR):
        shcsr = sparse.ShardedELL.from_csr(shcsr, torch.device("cpu"))
    shards = len(shcsr) if isinstance(shcsr, tuple) else shcsr.shards
    if shards != len(devices):
        raise ValueError(
            f"ShardedCSR built for {shards} shards but mesh axis {axes} has {len(devices)}"
        )
    if isinstance(shcsr, tuple):
        return shcsr
    return shcsr.shard_views(devices)


def mix_sharded_sparse_slabs(
    views: tuple[sparse.ShardView, ...],
    slabs: list[torch.Tensor],
    *,
    devices: list[torch.device],
    halo_schedule: str = "allgather",
    p_chunk: int | None = None,
) -> list[torch.Tensor]:
    """One sparse round over per-shard slabs: shard s's (blk, p) f32 slab on
    ``devices[s]`` in, its mixed rows out on the same device. Nothing is
    gathered to one device; the halo exchange is the only traffic between
    shards (the reference's ``_sharded_mix_leaf`` on every shard)."""
    ring = _resolve_ring(views[0], halo_schedule)
    got = _halo_exchange([_halo_sends(v, x, ring) for v, x in zip(views, slabs)],
                         devices, views, ring)
    return [_shard_rows(v, _halo_buffer(v, x, g, ring), p_chunk)
            for v, x, g in zip(views, slabs, got)]


def mix_sharded_sparse_faulted_slabs(
    views: tuple[sparse.ShardView, ...],
    slabs: list[torch.Tensor],
    pub: list[torch.Tensor] | None,
    keep: list[torch.Tensor],
    alive: list[torch.Tensor],
    *,
    devices: list[torch.device],
    halo_schedule: str = "allgather",
) -> list[torch.Tensor]:
    """One faulted sparse round over per-shard slabs (cf.
    ``mix_sharded_sparse_slabs``): ``pub`` the shards' published snapshots
    (None: every publish is fresh), ``keep`` each shard's (E,) entry mask
    and ``alive`` its (blk,) node mask, on its device."""
    ring = _resolve_ring(views[0], halo_schedule)
    srcs = slabs if pub is None else pub
    got = _halo_exchange([_halo_sends(v, x, ring) for v, x in zip(views, srcs)],
                         devices, views, ring)
    return [_shard_rows_faulted(v, _halo_buffer(v, x, g, ring), c, k, a, pub is not None)
            for v, x, g, c, k, a in zip(views, srcs, got, slabs, keep, alive)]


def mix_sharded_sparse(
    shcsr,
    params: PyTree,
    *,
    mesh,
    node_axis: str | tuple[str, ...] = "data",
    p_chunk: int | None = None,
    halo_schedule: str = "allgather",
) -> PyTree:
    """Sparse DecAvg round with the node axis split over ``node_axis``.

    ``shcsr`` is a ``core.sparse.ShardedCSR`` (or its device layout, a
    ``ShardedELL``, or that layout's per-shard views): each shard owns a
    contiguous row range of W with halo-local column ids. All leaves go side
    by side, are cut into one slab per shard on its device, and per shard:

      1. assemble the shard's halo, the source rows its entries reference,
         into an (H, p) buffer (``halo_schedule`` "allgather", "ring", or
         "auto": the ring when its modeled wire undercuts the allgather's);
      2. sum its rows' ELL slots over the buffer in slot order, as
         ``sparse.mix_ell`` sums the whole matrix: the same bits as the
         ``sparse`` backend for any S and either schedule.

    The rows come back to the params' device. ``p_chunk`` sums a CPU
    buffer in column slabs of that width (see ``_shard_rows``).
    """
    axes, _, devices = _shards_of(mesh, node_axis)
    views = _views_of(shcsr, devices, axes)

    def mix_cat(cat: torch.Tensor) -> torch.Tensor:
        outs = mix_sharded_sparse_slabs(views, _slabs(cat, devices), devices=devices,
                                        halo_schedule=halo_schedule, p_chunk=p_chunk)
        return mesh_mod.gather(outs, cat.device)

    return _mix_leaves_concatenated(params, views[0].n, mix_cat)


def mix_sharded_sparse_faulted(
    shcsr,
    params: PyTree,
    pub: PyTree,
    keep: torch.Tensor,
    alive: torch.Tensor,
    *,
    mesh,
    node_axis: str | tuple[str, ...] = "data",
    halo_schedule: str = "allgather",
) -> PyTree:
    """One faulted sharded sparse round (cf. ``mix_sharded_sparse``).

    ``keep`` is the round's (S, E) entry mask over the ``ShardedCSR``'s
    entries and ``alive`` the (N,) node mask. ``pub`` are the published
    snapshots (None: every publish is fresh). The halo exchange moves
    published rows; per shard the round is ``faults.mix_faulted_ell``'s on
    the shard's rows (renormalized surviving weights, the fresh self term
    when publishes are stale, dead and emptied rows bit-unchanged), so it
    gives the ``sparse`` backend's bits."""
    axes, _, devices = _shards_of(mesh, node_axis)
    views = _views_of(shcsr, devices, axes)
    blk = views[0].rows_per_shard

    def mix_cat(cat: torch.Tensor, pcat: torch.Tensor | None = None) -> torch.Tensor:
        outs = mix_sharded_sparse_faulted_slabs(
            views, _slabs(cat, devices), None if pcat is None else _slabs(pcat, devices),
            [keep[s].to(d) for s, d in enumerate(devices)],
            [alive[s * blk:(s + 1) * blk].to(d) for s, d in enumerate(devices)],
            devices=devices, halo_schedule=halo_schedule,
        )
        return mesh_mod.gather(outs, cat.device)

    more = () if pub is None else (pub,)
    return _mix_leaves_concatenated(params, views[0].n, mix_cat, *more)


def mix_permute(
    w: torch.Tensor,
    params: PyTree,
    colors: list[list[tuple[int, int]]],
    *,
    mesh,
    node_axis: str = "data",
) -> PyTree:
    """DecAvg round as a sum of edge-colored ``ppermute`` steps.

    Needs num_nodes == the mesh's node axis (one node a shard). Each color
    class (a matching, from ``mixing.edge_coloring``) is one ``ppermute``:
    a node receives only its neighbors' models, O(degree) of them, instead
    of the dense path's N. W entries off the graph are ignored. In f32, the
    self term first, then one term per color in color order."""
    _, k, devices = _shards_of(mesh, node_axis)
    if w.shape[0] != k:
        raise ValueError(f"mix_permute needs num_nodes == |{node_axis}| ({k}), got {w.shape[0]}")
    wf = w.float()
    self_coef = torch.diagonal(wf)
    color_coefs = []
    for pairs in colors:
        src = torch.as_tensor([a for a, _ in pairs], dtype=torch.int64, device=wf.device)
        dst = torch.as_tensor([b for _, b in pairs], dtype=torch.int64, device=wf.device)
        color_coefs.append(wf.new_zeros(k).index_put_((dst,), wf[dst, src]))

    def mix_one(leaf: torch.Tensor) -> torch.Tensor:
        slabs = _slabs(leaf.float(), devices)  # (1, ...) a shard
        acc = [x * self_coef[i].to(x.device) for i, x in enumerate(slabs)]
        for pairs, vec in zip(colors, color_coefs):
            got = mesh_mod.ppermute(slabs, pairs, devices)
            acc = [a + y * vec[i].to(y.device) for i, (a, y) in enumerate(zip(acc, got))]
        return torch.cat([a.to(leaf.device) for a in acc]).to(leaf.dtype)

    return tree_map(mix_one, params)


# ---------------------------------------------------------------------------
# MixingProgram: all schedule periods staged up front for a fused run
# ---------------------------------------------------------------------------


class ShardFaults(NamedTuple):
    """One shard's slice of a faulted program's masks, on its device:
    ``alive`` (rounds, blk), ``keep`` (rounds, E) over its entries and the
    straggler delays ``delay`` (blk,) of its nodes."""

    alive: torch.Tensor
    keep: torch.Tensor
    delay: torch.Tensor


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
    - kind "sparse_sharded": per-period ``ShardedCSR`` layouts padded to
      common widths (``sparse.stack_shard_csr``): the halo and the
      local/ring tables as the ``sh_*`` tensors with a leading period axis,
      and each shard's ELL view of its entries
      (``sh_ell_idx``/``sh_ell_val``/``sh_ell_pos`` (T, S, blk, K), summing
      ``sh_widths[s]`` slots), mixed by ``mix_sharded_sparse`` over
      ``mesh``'s ``node_axis`` with ``halo_schedule`` ("auto" resolves from
      the stacked widths, common to every period) and ``p_chunk``. Each
      period slot's per-shard views (``sh_views[t][s]``) and, on a faulted
      program, each shard's slice of the fault masks (``sh_faults[s]``)
      are staged once on the shard's device: ``apply_local`` and its pieces
      mix per-shard slabs with them, and never gather to one device.

    ``cadence`` is "always" (gossip_every == 1), "never" (0) or "mask".
    ``pad_ratio`` is stacked operator slots per real W entry (1.0 for dense).

    A ``faulted`` program (kinds "dense", "sparse" and "sparse_sharded")
    also holds the run's fault masks on the device: ``f_alive`` (rounds, N)
    bool, ``f_keep`` in the operator's own layout ((rounds, N, N) for dense,
    (rounds, N, K) over the ELL slots for sparse, (rounds, S, E) over the
    sharded entries, padding kept) and the static straggler delays
    ``f_delay`` (N,). Its mixing takes the round ``r`` as an int or as an
    int64 device tensor: a captured graph reads the round's masks through
    the tensor, so one graph serves every round of a period slot.
    """

    kind: str  # "dense" | "sparse" | "sparse_pallas" | "sparse_sharded"
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
    sh_halo: torch.Tensor | None = None  # (T, S, H) int64, kind == "sparse_sharded"
    sh_local_src: torch.Tensor | None = None  # (T, S, L) int64
    sh_local_dst: torch.Tensor | None = None  # (T, S, L) int64
    sh_ring_send: tuple[torch.Tensor, ...] = ()  # per ring step: (T, S, K_d) int64
    sh_ring_recv: tuple[torch.Tensor, ...] = ()
    sh_ell_idx: torch.Tensor | None = None  # (T, S, blk, K) int64, halo-local
    sh_ell_val: torch.Tensor | None = None  # (T, S, blk, K) f32
    sh_ell_pos: torch.Tensor | None = None  # (T, S, blk, K) int64, entry of each slot
    sh_widths: tuple[int, ...] = ()  # slots shard s sums
    sh_views: tuple[tuple[sparse.ShardView, ...], ...] = ()  # [t][s], on shard s's device
    sh_faults: tuple["ShardFaults", ...] = ()  # [s], on shard s's device
    mesh: Any = None  # kind == "sparse_sharded"
    node_axis: str | tuple[str, ...] | None = None
    shards: int | None = None
    halo_schedule: str | None = None
    pad_ratio: float = 1.0
    faulted: bool = False
    delay_max: int = 0
    f_alive: torch.Tensor | None = None  # (rounds, N) bool
    f_keep: torch.Tensor | None = None  # (rounds, N, N) | (rounds, N, K) | (rounds, S, E) bool
    f_delay: torch.Tensor | None = None  # (N,) int32

    @property
    def rounds(self) -> int:
        return int(self.period_idx.shape[0])

    def apply_period(self, params: PyTree, t: int, *, r=None, pub: PyTree = None) -> PyTree:
        """One unconditional mixing round with period slot ``t``'s operator.
        Reads only views of the stacked tensors, so it can be captured.

        On a faulted program, round ``r``'s masks (``r`` an int or an int64
        device tensor) renormalize the operator and ``pub`` supplies the
        published snapshots (None: every publish is fresh, the same round as
        the engine's loop path mixes, to the bit)."""
        if self.faulted:
            if r is None:
                raise ValueError("a faulted program mixes at a round (r=...)")
            keep, alive = _row(self.f_keep, r), _row(self.f_alive, r)
            if self.kind == "sparse_sharded":
                return mix_sharded_sparse_faulted(
                    self.sh_views[t], params, pub, keep, alive, mesh=self.mesh,
                    node_axis=self.node_axis, halo_schedule=self.halo_schedule,
                )
            if self.kind == "dense":
                return faults_mod.mix_faulted_dense(self.w[t], keep, alive, params, pub)
            return faults_mod.mix_faulted_ell(
                self.ell_idx[t], self.ell_val[t], keep, alive, params, pub
            )
        if self.kind == "dense":
            return mix_dense(self.w[t], params)
        if self.kind == "sparse":
            return sparse.mix_ell(self.ell_idx[t], self.ell_val[t], params, p_chunk=self.p_chunk)
        if self.kind == "sparse_sharded":
            return mix_sharded_sparse(
                self.sh_views[t], params, mesh=self.mesh, node_axis=self.node_axis,
                p_chunk=self.p_chunk, halo_schedule=self.halo_schedule,
            )
        return sparse.mix_kernel(
            ops.gossip_mix_sparse_blocked, self.bell_idx[t], self.bell_val[t], params
        )

    # -- kind "sparse_sharded" over per-shard slabs (the reference's
    # ``apply_local`` and ``mix_at_local``): the pieces run one shard at a
    # time on its own device, and only ``exchange`` moves data between them.

    @property
    def shard_devices(self) -> list[torch.device]:
        """The device of each shard of the node axis, in shard order."""
        return self.mesh.shard_devices(mesh_mod.axes_of(self.node_axis))

    @property
    def ring(self) -> bool:
        """Whether the halo goes round the ring (else the allgather),
        resolved once from the stacked widths, common to every period."""
        return _resolve_ring(self.sh_views[0][0], self.halo_schedule)

    def local_sends(self, t: int, s: int, src: torch.Tensor) -> list[torch.Tensor]:
        """Shard ``s``'s part of period slot ``t``'s halo exchange, from its
        (blk, p) slab ``src`` (the published snapshots on a faulted round
        with stragglers)."""
        return _halo_sends(self.sh_views[t][s], src, self.ring)

    def exchange(self, t: int, sends: list[list[torch.Tensor]]) -> list[list[torch.Tensor]]:
        """Slot ``t``'s halo exchange over every shard's ``local_sends``:
        the round's only traffic between shards."""
        return _halo_exchange(sends, self.shard_devices, self.sh_views[t], self.ring)

    def local_rows(self, t: int, s: int, src: torch.Tensor, got: list[torch.Tensor], *,
                   r=None, cur: torch.Tensor | None = None, stale: bool = False) -> torch.Tensor:
        """Shard ``s``'s mixed (blk, p) rows for slot ``t``, from its slab
        ``src`` and what it received (``got``). On a faulted program, round
        ``r``'s masks (``r`` an int or an int64 tensor on the shard's
        device), ``cur`` its current params and ``stale`` when ``src`` holds
        published snapshots."""
        view = self.sh_views[t][s]
        buf = _halo_buffer(view, src, got, self.ring)
        if not self.faulted:
            return _shard_rows(view, buf, self.p_chunk)
        f = self.sh_faults[s]
        return _shard_rows_faulted(view, buf, cur, _row(f.keep, r), _row(f.alive, r), stale)

    def apply_local(self, params: list[PyTree], r: int,
                    pub: list[PyTree] | None = None) -> list[PyTree]:
        """Kind "sparse_sharded": round ``r``'s mix of per-shard slabs, shard
        s's (blk, ...) tree on its own device in and out. ``pub`` are the
        shards' published snapshots on a faulted program (None: fresh)."""
        t = int(self.period_idx[r])
        cats = [_cat_leaves(p) for p in params]
        srcs = cats if pub is None else [_cat_leaves(q) for q in pub]
        got = self.exchange(t, [self.local_sends(t, s, x) for s, x in enumerate(srcs)])
        return [
            _split_leaves(self.local_rows(t, s, srcs[s], got[s], r=r, cur=cats[s],
                                          stale=pub is not None), params[s])
            for s in range(len(params))
        ]

    def mix_at_local(self, params: list[PyTree], r: int,
                     pub: list[PyTree] | None = None) -> list[PyTree]:
        """``apply_local`` gated by the gossip cadence (cf. ``mix_at``)."""
        if not self.gossip_mask[r]:
            return params
        return self.apply_local(params, r, pub)

    def alive_at(self, r) -> torch.Tensor:
        """Round ``r``'s (N,) alive mask on a faulted program (``r`` an int
        or an int64 device tensor)."""
        return _row(self.f_alive, r)

    def apply(self, params: PyTree, r: int, pub: PyTree = None) -> PyTree:
        """One unconditional mixing round with round ``r``'s operator (and,
        on a faulted program, its masks)."""
        return self.apply_period(params, int(self.period_idx[r]), r=r, pub=pub)

    def mix_at(self, params: PyTree, r: int, pub: PyTree = None) -> PyTree:
        """``apply`` gated by the gossip cadence (identity on skip rounds)."""
        if not self.gossip_mask[r]:
            return params
        return self.apply(params, r, pub)


def _row(x: torch.Tensor, r) -> torch.Tensor:
    """``x[r]``, where ``r`` may be an int64 device tensor: then an
    ``index_select`` on the device, so a captured graph reads the round from
    the tensor at replay instead of baking it in."""
    if isinstance(r, torch.Tensor):
        return x.index_select(0, r.reshape(1))[0]
    return x[r]


# ---------------------------------------------------------------------------
# GossipEngine
# ---------------------------------------------------------------------------

_MATRIX_KINDS = ("decavg", "uniform", "mh")
_SPARSE_KINDS = ("sparse", "sparse_pallas", "sparse_sharded")
_MESH_BACKENDS = ("sharded", "sparse_sharded", "permute")

# Backend -> {requires, cost, wire, fused, faults, notes}, the same columns
# as the reference's table. ``fused`` means ``program()`` stages every
# schedule period for the backend, so ``DecentralizedTrainer.run_fused``
# covers it (its ``_FUSED_BACKENDS`` mirrors the flag). ``faults`` means the
# backend mixes the core/faults.py renormalized round: the kernels take W
# as it is and the dense-sharded and permute paths fix their coefficients,
# so per-round renormalization is dense, sparse and sparse_sharded
# territory, as in the reference.
_BACKEND_INFO = {
    "dense": {
        "requires": "any device; W materialized (N,N)",
        "cost": "O(N^2 * P)",
        "wire": "—",
        "fused": True,
        "faults": True,
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
        "faults": True,
        "notes": "ELL gather + fixed-order f32 sum (deterministic, no "
                 "atomics): one launch of the hand-written CUDA ELL sum "
                 "kernel (kernels/csrc/ell_sum.cu) a leaf on the card, plain "
                 "torch on CPU tensors, the same bits; default at N >= 512",
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
    "sharded": {
        "requires": "core.mesh.Mesh with node axis; N divisible by shards",
        "cost": "O(N^2 * P / S) per shard",
        "wire": "always O(N * P) allgather",
        "fused": False,
        "faults": False,
        "notes": "per-shard torch.matmul, allgather / reduce-scatter",
    },
    "sparse_sharded": {
        "requires": "core.mesh.Mesh with node axis (default: one shard per "
                    "local CUDA card, one on the CPU); N divisible by shards; "
                    "W stored per-shard CSR with halo columns; halo_schedule "
                    "allgather|ring|auto",
        "cost": "O(E * P / S) work per shard",
        "wire": "allgather O(N * P) / ring O(H * P); auto picks ring when "
                "it undercuts",
        "fused": True,
        "faults": True,
        "notes": "per-shard CSR row ranges + halo buffers, summed in the "
                 "sparse backend's order (same bits for any S); default at "
                 "N >= 512 with a mesh",
    },
    "permute": {
        "requires": "core.mesh.Mesh with node axis; N == |axis|; recolors per "
                    "schedule period",
        "cost": "O(degree * P) compute per shard",
        "wire": "O(degree * P) per shard",
        "fused": False,
        "faults": False,
        "notes": "edge-colored ppermute schedule; recolors per period for "
                 "time-varying schedules",
    },
}


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
      backend: one of ``GossipEngine.BACKENDS`` or "auto" (sparse at
        N >= ``sparse_threshold``, else dense; with a mesh, sparse_sharded
        at N >= ``sparse_threshold`` or under faults, else sharded).
        "sparse_sharded" without a mesh builds ``core.mesh.local_mesh``
        on the engine's device.
      gossip_every: mix on rounds with ``round % gossip_every == 0``; 0
        disables gossip (isolated training).
      mesh/node_axis/sharded_schedule: for the mesh backends (a
        ``core.mesh.Mesh``; ``sharded_schedule`` "allgather" or
        "reduce_scatter" for ``sharded``).
      halo_schedule: sparse_sharded halo assembly, "allgather", "ring" or
        "auto" (the ring whenever its modeled wire undercuts the allgather's).
      sparse_p_chunk: feature-axis chunk for the plain sparse gather on
        the CPU: an int, "auto" (sized from nnz to a ~16 MiB transient), or
        None (off). The card's ELL sum kernel needs no gather buffer and
        sums the whole width in one launch whatever it is.
      faults: a fault spec (core/faults.py grammar) or ``FaultSchedule``;
        needs a fault-capable backend (dense, sparse, sparse_sharded) and
        refuses ``sparse_p_chunk``. ``mix`` then needs ``round=``.
      validate: check every period's W (``mixing.validate_mixing``) and
        every staged CSR's row sums.
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
        mesh: mesh_mod.Mesh | None = None,
        node_axis: str = "data",
        sharded_schedule: str = "reduce_scatter",
        halo_schedule: str = "auto",
        sparse_threshold: int = 512,
        sparse_p_chunk: int | str | None = None,
        faults: Any = None,
        validate: bool = True,
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
        self.mesh = mesh
        self.node_axis = node_axis
        self.sharded_schedule = sharded_schedule
        if halo_schedule not in ("allgather", "ring", "auto"):
            raise ValueError(
                f"halo_schedule must be 'allgather', 'ring' or 'auto', got {halo_schedule!r}"
            )
        self.halo_schedule = halo_schedule
        self.sparse_threshold = int(sparse_threshold)
        self.sparse_p_chunk = sparse_p_chunk
        self.validate = bool(validate)
        self.seed = int(seed)
        self.faults = None
        if faults is not None:
            self.faults = faults_mod.FaultSchedule.parse(faults)
            if sparse_p_chunk is not None:
                raise ValueError(
                    "faults do not compose with sparse_p_chunk: the faulted "
                    "mix renormalizes per entry, so chunked gathers would "
                    "redo it per chunk for no transient win"
                )
        self._fault_trace: faults_mod.FaultTrace | None = None
        self._fault_hist: PyTree = None  # loop-path straggler ring buffer (mix())
        self.backend = self._resolve_backend(backend)
        if self.backend == "sparse_sharded" and self.mesh is None:
            self.mesh = self._default_node_mesh()
        self.check(self.backend)
        self._period: int | None = None
        self._graph = None
        self._w: torch.Tensor | None = None
        self._csr: sparse.CSR | None = None
        self._ell: tuple[torch.Tensor, torch.Tensor] | None = None
        self._bell: tuple[torch.Tensor, torch.Tensor] | None = None
        self._ell_np: tuple[np.ndarray, np.ndarray] | None = None
        self._shcsr: sparse.ShardedCSR | None = None
        self._sh_views: tuple | None = None  # (devices, per-shard views) of _shcsr
        self._colors: list | None = None
        # Edge colorings are fixed per schedule period: cached, so revisiting
        # a period (or mixing again within one) never recolors.
        self._colors_cache: dict[int, list] = {}
        self.refresh(0)

    @classmethod
    def capabilities(cls) -> dict[str, dict[str, str | bool]]:
        """Backend -> {requires, cost, wire, fused, faults, notes}."""
        return {b: dict(info) for b, info in _BACKEND_INFO.items()}

    def _resolve_backend(self, backend: str) -> str:
        if backend != "auto":
            if backend not in _BACKEND_INFO:
                raise ValueError(
                    f"unknown backend {backend!r}; one of {self.BACKENDS} or 'auto'"
                )
            return backend
        if self.mesh is not None:
            return (
                "sparse_sharded"
                if self.faults is not None or self.num_nodes >= self.sparse_threshold
                else "sharded"
            )
        return "sparse" if self.num_nodes >= self.sparse_threshold else "dense"

    def _default_node_mesh(self) -> mesh_mod.Mesh:
        """The sparse_sharded default: a 1-D mesh over ``node_axis`` with one
        shard per local CUDA card on a CUDA engine, one on the CPU."""
        return mesh_mod.local_mesh(self.node_axis, device=self.device)

    def check(self, backend: str, mesh=None) -> None:
        """Raise with an actionable message if ``backend`` cannot run here.
        ``mesh`` overrides ``self.mesh`` for the check (per-call overrides)."""
        if backend not in _BACKEND_INFO:
            raise ValueError(f"unknown backend {backend!r}; one of {self.BACKENDS}")
        mesh = self.mesh if mesh is None else mesh
        if backend in _MESH_BACKENDS and mesh is None:
            raise ValueError(f"backend {backend!r} needs a mesh (mesh=...)")
        if backend == "permute":
            k = mesh_mod.axis_size(mesh, self.node_axis)
            if self.num_nodes != k:
                raise ValueError(
                    f"backend 'permute' needs num_nodes == |{self.node_axis}| "
                    f"({k}), got {self.num_nodes}"
                )
        if backend in ("sharded", "sparse_sharded"):
            shards = mesh_mod.axis_size(mesh, self.node_axis)
            if self.num_nodes % shards:
                raise ValueError(
                    f"backend {backend!r}: num_nodes {self.num_nodes} not divisible "
                    f"by node shards {shards}"
                )
        if self.faults is not None and not _BACKEND_INFO[backend]["faults"]:
            capable = tuple(b for b, info in _BACKEND_INFO.items() if info["faults"])
            raise ValueError(
                f"backend {backend!r} does not support faults; "
                f"fault-capable backends: {capable}"
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
        if self.validate:
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
        self._ell_np = None  # its host arrays
        self._shcsr = None  # sharded view of _csr, built on first use
        self._sh_views = None  # its per-shard views on the shards' devices
        self._colors = self._coloring_for(period, g) if self.backend == "permute" else None
        return True

    def _coloring_for(self, period: int, graph) -> list:
        """Edge coloring for ``period``, cached: recoloring per schedule
        period is what lets ``permute`` follow time-varying topologies."""
        colors = self._colors_cache.get(period)
        if colors is None:
            colors = mixing.edge_coloring(graph)
            if len(self._colors_cache) >= 64:  # bound memory on long regen runs
                self._colors_cache.pop(next(iter(self._colors_cache)))
            self._colors_cache[period] = colors
        return colors

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

    def sharded_csr(self, mesh=None) -> sparse.ShardedCSR:
        """The current period's ``ShardedCSR`` for the mesh's shard count
        (cached; rebuilt on a new period or another shard count)."""
        mesh = self.mesh if mesh is None else mesh
        shards = mesh_mod.axis_size(mesh, self.node_axis)
        if self._shcsr is None or self._shcsr.shards != shards:
            self._shcsr = sparse.shard_csr(self.csr, shards)
            self._sh_views = None
        return self._shcsr

    def _sharded_view(self, mesh=None) -> tuple[sparse.ShardView, ...]:
        """The current period's per-shard views, each on its shard's device
        (cached; rebuilt on a new period or another mesh)."""
        mesh = self.mesh if mesh is None else mesh
        shcsr = self.sharded_csr(mesh)
        devices = tuple(mesh.shard_devices(mesh_mod.axes_of(self.node_axis)))
        if self._sh_views is None or self._sh_views[0] != devices:
            layout = sparse.ShardedELL.from_csr(shcsr, self.device)
            self._sh_views = (devices, layout.shard_views(list(devices)))
        return self._sh_views[1]

    @property
    def shard_devices(self) -> list[torch.device]:
        """The device of each shard of the node axis, in shard order (mesh
        backends)."""
        return self.mesh.shard_devices(mesh_mod.axes_of(self.node_axis))

    def mix_slabs(self, slabs: list[torch.Tensor], *, masks=None,
                  pub: list[torch.Tensor] | None = None) -> list[torch.Tensor]:
        """sparse_sharded: the current period's mix of one node-stacked leaf
        held as per-shard slabs, shard s's (blk, ...) tensor on its device
        in and its mixed slab out there, in the leaf's dtype (call
        ``refresh`` first). Nothing is gathered to one device; the halo
        exchange is the only traffic between shards, and the rows are
        ``mix_sharded_sparse``'s, so ``sparse``'s bits. ``masks`` (from
        ``shard_masks``) makes it the faulted round, over the shards'
        published snapshots ``pub`` (None: fresh)."""
        views = self._sharded_view()
        flat = [x.reshape(x.shape[0], -1).float() for x in slabs]
        if masks is None:
            outs = mix_sharded_sparse_slabs(
                views, flat, devices=self.shard_devices, halo_schedule=self.halo_schedule,
                p_chunk=self._p_chunk(int(self._shcsr.values.shape[1])),
            )
        else:
            outs = mix_sharded_sparse_faulted_slabs(
                views, flat, None if pub is None else [q.reshape(q.shape[0], -1).float()
                                                       for q in pub],
                *masks, devices=self.shard_devices, halo_schedule=self.halo_schedule,
            )
        return [o.reshape(x.shape).to(x.dtype) for o, x in zip(outs, slabs)]

    def shard_masks(self, round: int) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        """Round ``round``'s fault masks cut per shard, each on its shard's
        device: the (E,) entry keep over the current period's
        ``ShardedCSR`` and the (blk,) alive rows of its nodes."""
        keep = self.sharded_keep(round)
        alive = self.fault_trace.alive(round)
        devices = self.shard_devices
        blk = self.num_nodes // len(devices)
        return ([torch.as_tensor(keep[s], device=d) for s, d in enumerate(devices)],
                [torch.as_tensor(alive[s * blk:(s + 1) * blk], device=d)
                 for s, d in enumerate(devices)])

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

    @property
    def fault_trace(self) -> faults_mod.FaultTrace:
        """The engine's deterministic ``FaultTrace`` (requires ``faults=``),
        built on first use: loop mixing, fused staging and the runner's
        analytics read the same per-round masks."""
        if self.faults is None:
            raise ValueError("engine has no fault schedule (faults=...)")
        if self._fault_trace is None:
            self._fault_trace = faults_mod.FaultTrace(self.faults, self.schedule, seed=self.seed)
        return self._fault_trace

    def _ell_host(self) -> tuple[np.ndarray, np.ndarray]:
        if self._ell_np is None:
            self._ell_np = sparse.ell_from_csr(self.csr)
        return self._ell_np

    def _ell_view(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self._ell is None:
            idx, val = self._ell_host()
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

    def mix(
        self,
        params: PyTree,
        *,
        round: int | None = None,
        backend: str | None = None,
        spec: str | None = None,
    ) -> PyTree:
        """One communication round.

        With ``round`` given, the engine applies the cadence (identity rounds
        return ``params`` untouched) and refreshes schedule state for that
        round. Without it, the current-period matrix is applied
        unconditionally. ``backend`` (alias ``spec``) overrides the engine's
        backend for this call only; it is checked, and later calls are
        unaffected (a ``sparse_sharded`` override without a mesh builds one
        for the call).

        With ``faults=`` set the engine runs the faulted round instead (it
        needs ``round``): straggler snapshots from an internal ring buffer
        that assumes one call per round, in round order; renormalized mixing
        over surviving neighbors; dead and emptied rows passed through
        bit-unchanged. Freezing dead nodes' training is the trainer's job.
        """
        backend = backend or spec or self.backend
        if self.faults is not None:
            if backend != self.backend:
                self.check(backend)
            if round is None:
                raise ValueError("faulted mixing needs round= (per-round masks)")
            return self._mix_faulted(params, round, backend)
        mesh = self.mesh
        if backend != self.backend:
            if backend == "sparse_sharded" and mesh is None:
                mesh = self._default_node_mesh()  # this call's only
            self.check(backend, mesh)
        if round is not None:
            if not self.is_gossip_round(round):
                return params
            self.refresh(round)
        if backend == "dense":
            return mix_dense(self._w, params)
        if backend == "pallas":
            return mix_pallas(self._w, params)
        if backend == "sparse":
            idx, val = self._ell_view()
            return sparse.mix_ell(idx, val, params, p_chunk=self._p_chunk(self.csr.nnz))
        if backend == "sparse_pallas":
            # The blocked kernel on the card; on the CPU the scalar kernel's
            # plain version, as the reference picks the scalar kernel off
            # the TPU.
            if self.device.type == "cuda":
                return sparse.mix_kernel(ops.gossip_mix_sparse_blocked, *self._bell_view(), params)
            return sparse.mix_kernel(ops.gossip_mix_sparse, *self._ell_view(), params)
        if backend == "sharded":
            return mix_sharded(self._w, params, mesh=mesh, node_axis=self.node_axis,
                               schedule=self.sharded_schedule)
        if backend == "sparse_sharded":
            layout = self._sharded_view(mesh)
            # Sized from the per-shard entry count, as the reference does.
            p_chunk = self._p_chunk(int(self._shcsr.values.shape[1]))
            return mix_sharded_sparse(layout, params, mesh=mesh, node_axis=self.node_axis,
                                      p_chunk=p_chunk, halo_schedule=self.halo_schedule)
        if self._colors is None:  # permute
            self._colors = self._coloring_for(self._period, self._graph)
        return mix_permute(self._w, params, self._colors, mesh=mesh, node_axis=self.node_axis)

    def _mix_faulted(self, params: PyTree, round: int, backend: str) -> PyTree:
        """One faulted loop-path round (see ``mix``)."""
        self.refresh(round)
        trace = self.fault_trace
        # Push into the straggler ring buffer BEFORE the cadence gate: a
        # straggler's history advances whether or not this round gossips.
        pub = None
        if trace.delay_max > 0:
            if self._fault_hist is None:
                self._fault_hist = faults_mod.init_history(params, trace.delay_max + 1)
            pub, _ = faults_mod.push_and_publish(
                params, self._fault_hist, round, self.fault_delay()
            )
        if not self.is_gossip_round(round):
            return params
        return self.mix_faulted(params, round, pub, backend=backend)

    def fault_delay(self) -> torch.Tensor:
        """The static per-node straggler delays, (N,) int32 on the device."""
        return torch.as_tensor(self.fault_trace.delay, device=self.device)

    def sharded_keep(self, round: int) -> np.ndarray:
        """Round ``round``'s (S, E) entry-keep mask over the current
        period's ``ShardedCSR``: each entry's global row ``rows + s*blk``
        and column ``halo[cols]``, as the reference builds it."""
        shcsr = self.sharded_csr()
        rows_g = shcsr.rows + np.arange(shcsr.shards)[:, None] * shcsr.rows_per_shard
        cols_g = np.take_along_axis(shcsr.halo, shcsr.cols, axis=1)
        return self.fault_trace.entry_keep(round, rows_g, cols_g, shcsr.values)

    def mix_faulted(self, params: PyTree, round: int, pub: PyTree = None, *,
                    backend: str | None = None) -> PyTree:
        """One unconditional faulted round with round ``round``'s masks over
        the current period's W (call ``refresh(round)`` first). ``pub`` are
        the published snapshots (None: every publish is fresh)."""
        backend = backend or self.backend
        trace = self.fault_trace
        alive = torch.as_tensor(trace.alive(round), device=self.device)
        if backend == "dense":
            keep = torch.as_tensor(trace.dense_keep(round), device=self.device)
            return faults_mod.mix_faulted_dense(self._w, keep, alive, params, pub)
        if backend == "sparse":
            idx, val = self._ell_host()
            rows = np.arange(self.num_nodes)[:, None]
            keep = trace.entry_keep(round, np.broadcast_to(rows, idx.shape), idx, val)
            return faults_mod.mix_faulted_ell(
                *self._ell_view(), torch.as_tensor(keep, device=self.device), alive, params, pub
            )
        if backend == "sparse_sharded":
            layout = self._sharded_view()
            keep = torch.as_tensor(self.sharded_keep(round))
            return mix_sharded_sparse_faulted(
                layout, params, pub, keep, alive, mesh=self.mesh, node_axis=self.node_axis,
                halo_schedule=self.halo_schedule,
            )
        raise ValueError(f"backend {backend!r} does not support faults")

    def program(self, rounds: int, *, kind: str | None = None) -> MixingProgram:
        """Stage every schedule period of a ``rounds``-long run up front.

        ``kind`` defaults to the backend for the sparse backends and "dense"
        otherwise. The sparse kinds build each period's CSR straight from the
        schedule's graphs (``sparse.csr_from_graph``), as ``refresh`` does,
        so the dense (N, N) matrix is never stacked. For the dense kind the
        engine's period state is walked and then restored to round 0. Kind
        "sparse_sharded" uses the engine's mesh, or the default one.

        With ``faults=`` set, the program also stages the whole run's
        per-round alive and entry-keep masks and the static straggler delays
        (``_attach_faults``).
        """
        prog = self._program_operators(rounds, kind=kind)
        if self.faults is None or prog.faulted:
            return prog
        return self._attach_faults(prog, int(rounds))

    def _attach_faults(self, prog: MixingProgram, rounds: int,
                       keep: np.ndarray | None = None) -> MixingProgram:
        """The fault axis of a built program: per-round alive masks, and
        entry-keep masks in the program's own operator layout (dense W, the
        ELL slots of each round's period, or the sharded (S, E) entries,
        padding kept, which ``_program_sharded`` builds and passes as
        ``keep``)."""
        trace = self.fault_trace
        trace.ensure(rounds)
        if keep is None and prog.kind == "dense":
            keep = np.stack([trace.dense_keep(r) for r in range(rounds)])
        elif keep is None and prog.kind == "sparse":
            idx = prog.ell_idx.cpu().numpy()
            val = prog.ell_val.cpu().numpy()
            rows = np.broadcast_to(np.arange(prog.n)[:, None], idx.shape[1:])
            keep = np.stack([
                trace.entry_keep(r, rows, idx[t], val[t])
                for r, t in enumerate(prog.period_idx)
            ])
        elif keep is None:
            raise ValueError(f"program kind {prog.kind!r} does not support faults")
        return dataclasses.replace(
            prog,
            faulted=True,
            delay_max=trace.delay_max,
            f_alive=torch.as_tensor(trace.alive_matrix(rounds), device=self.device),
            f_keep=torch.as_tensor(keep, device=self.device),
            f_delay=torch.as_tensor(trace.delay, device=self.device),
        )

    def _program_operators(self, rounds: int, *, kind: str | None = None) -> MixingProgram:
        """The fault-free operator staging behind ``program`` (docs there)."""
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
        for c in csrs if self.validate else ():  # O(E) row sums, no dense rebuild
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
        if kind == "sparse_sharded":
            return self._program_sharded(csrs, real_nnz, common)
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

    def _program_sharded(self, csrs: list[sparse.CSR], real_nnz: int,
                         common: dict) -> MixingProgram:
        """Kind "sparse_sharded": every period's ``ShardedCSR`` stacked
        (``sparse.stack_shard_csr``) and each shard's ELL view of it, padded
        to a common slot count."""
        mesh = self.mesh if self.mesh is not None else self._default_node_mesh()
        self.check("sparse_sharded", mesh)
        shards = mesh_mod.axis_size(mesh, self.node_axis)
        st = sparse.stack_shard_csr([sparse.shard_csr(c, shards) for c in csrs])
        blk = self.num_nodes // shards
        ells = [sparse.shard_ell(st["rows"][t], st["cols"][t], st["values"][t], blk)
                for t in range(len(csrs))]
        k = max(e[0].shape[2] for e in ells)

        def stack(i: int) -> np.ndarray:
            return np.stack([np.pad(e[i], ((0, 0), (0, 0), (0, k - e[i].shape[2]))) for e in ells])

        def dev(a: np.ndarray, dtype=torch.int64) -> torch.Tensor:
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        stacked = dict(
            sh_halo=dev(st["halo"]),
            sh_local_src=dev(st["local_src"]), sh_local_dst=dev(st["local_dst"]),
            sh_ring_send=tuple(dev(a) for a in st["ring_send"]),
            sh_ring_recv=tuple(dev(a) for a in st["ring_recv"]),
            sh_ell_idx=dev(stack(0)), sh_ell_val=dev(stack(1), torch.float32),
            sh_ell_pos=dev(stack(2)),
            sh_widths=tuple(max(e[3][s] for e in ells) for s in range(shards)),
        )
        devices = mesh.shard_devices(mesh_mod.axes_of(self.node_axis))
        views = tuple(
            sparse.ShardedELL(
                halo=stacked["sh_halo"][t], local_src=stacked["sh_local_src"][t],
                local_dst=stacked["sh_local_dst"][t],
                ring_send=tuple(a[t] for a in stacked["sh_ring_send"]),
                ring_recv=tuple(a[t] for a in stacked["sh_ring_recv"]),
                idx=stacked["sh_ell_idx"][t], val=stacked["sh_ell_val"][t],
                pos=stacked["sh_ell_pos"][t], widths=stacked["sh_widths"], n=self.num_nodes,
            ).shard_views(devices)
            for t in range(len(csrs))
        )
        prog = MixingProgram(
            kind="sparse_sharded", **stacked, sh_views=views,
            mesh=mesh, node_axis=self.node_axis, shards=shards,
            halo_schedule=self.halo_schedule,
            # Sized from the padded per-shard entry count, as the reference.
            p_chunk=self._p_chunk(int(st["values"].shape[2])),
            pad_ratio=st["values"].size / real_nnz,
            **common,
        )
        if self.faults is None:
            return prog
        # Each entry's global row rows + s*blk and column halo[cols], from
        # the host layout, as ``sharded_keep`` builds one round's.
        rows_g = st["rows"] + np.arange(shards)[:, None] * blk
        cols_g = np.take_along_axis(st["halo"], st["cols"], axis=2)
        rounds = len(common["period_idx"])
        self.fault_trace.ensure(rounds)
        keep = np.stack([
            self.fault_trace.entry_keep(r, rows_g[t], cols_g[t], st["values"][t])
            for r, t in enumerate(common["period_idx"])
        ])
        prog = self._attach_faults(prog, rounds, keep)
        return dataclasses.replace(prog, sh_faults=tuple(
            ShardFaults(
                alive=prog.f_alive[:, s * blk:(s + 1) * blk].to(d).contiguous(),
                keep=prog.f_keep[:, s].to(d).contiguous(),
                delay=prog.f_delay[s * blk:(s + 1) * blk].to(d).contiguous(),
            )
            for s, d in enumerate(devices)
        ))

    def __repr__(self) -> str:
        return (
            f"GossipEngine(n={self.num_nodes}, backend={self.backend}, "
            f"matrix={self.matrix}, gossip_every={self.gossip_every}, "
            f"device={self.device}, topology={self.schedule!r})"
        )


def gossip_error(params: PyTree) -> torch.Tensor:
    """Consensus distance: mean over leaves of ||w_i - mean_i w_i||^2 / ||mean||^2.

    The quantity the spectral gap contracts per round; benchmarks report it
    to connect topology properties to knowledge-spread speed.
    """

    def leaf_err(leaf: torch.Tensor) -> torch.Tensor:
        f = leaf.reshape(leaf.shape[0], -1).float()
        mean = f.mean(dim=0, keepdim=True)
        num = ((f - mean) ** 2).sum()
        den = (mean**2).sum() * f.shape[0] + 1e-12
        return num / den

    return torch.stack([leaf_err(leaf) for leaf in tree_leaves(params)]).mean()
