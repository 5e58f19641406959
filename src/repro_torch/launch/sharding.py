"""Sharding rules: map every leaf of params / optimizer state / batch /
cache trees to a partition spec on a named mesh.

The port of ``repro/launch/sharding.py``. The rules are pure functions of
the leaf's path, its shape and ``mesh.shape``, and give the reference's
specs entry for entry; a spec is a ``PartitionSpec``, a tuple whose entry
for each tensor dimension is a mesh axis name, a tuple of names, or None
(replicated). Where the reference returns a ``NamedSharding`` the port
returns the spec alone: the mesh is the caller's. ``local_slab`` cuts a
global tensor into one mesh position's slab by such a spec (a view).
``place`` is the counterpart of ``jax.device_put(tree, NamedSharding(mesh,
spec))``: every mesh position's slab of every leaf, held on that position's
device (a view where that device is the tree's own, one tensor for the
positions of one card that hold the same slab); ``global_view`` rebuilds
the global tree from the slabs.

Policy (the reference's):
- node axis (leading, training only): sharded over the longest prefix of
  ("pod", "data") that divides num_nodes (``mesh.node_axes_for``);
  replicated otherwise.
- tensor parallel ("model"): the fused-head / ffn / expert dim on
  in-projections, the contraction dim on out-projections (megatron
  column/row split); MoE experts use expert parallelism (E -> "model").
- FSDP ("data", only when the node axis leaves it free): the d_model dim of
  each large matrix.
Each choice is checked for divisibility (e.g. minicpm's vocab 122753 falls
back to replicating the vocab dim and sharding d_model).
"""

from __future__ import annotations

from typing import Any

import itertools

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.mesh import axes_of, axis_index, axis_size, same_device
from repro_torch.launch.mesh import node_axes_for
from repro_torch.tree import tree_map_with_path

__all__ = [
    "PartitionSpec",
    "P",
    "leaf_spec",
    "param_shardings",
    "batch_shardings",
    "decode_shardings",
    "prefill_shardings",
    "local_slab",
    "map_specs",
    "Placed",
    "place",
    "global_view",
]

PyTree = Any


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s stand-in: one entry per tensor
    dimension, each a mesh axis name, a tuple of names, or None. As in JAX, a
    one-name tuple is stored as the name and an empty tuple as None."""

    def __new__(cls, *parts):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return e[0] if len(e) == 1 else (e or None)
            return e

        return super().__new__(cls, tuple(norm(e) for e in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _divides(dim: int, size: int) -> bool:
    return dim % size == 0


def leaf_spec(
    path: str,
    shape: tuple[int, ...],
    cfg: ArchConfig,
    mesh,
    *,
    node_axes: tuple[str, ...] = (),
    has_node_axis: bool = False,
) -> PartitionSpec:
    """PartitionSpec for one parameter leaf."""
    model = mesh.shape.get("model", 1)
    data = mesh.shape.get("data", 1)
    data_free = "data" not in node_axes
    ndim = len(shape)
    specs: list = [None] * ndim
    start = 0
    if has_node_axis:
        specs[0] = node_axes if node_axes else None
        start = 1

    body = shape[start:]
    if not body:
        return P(*specs)
    off = start  # index offset of body dim 0 in the full shape

    def try_set(rel_idx: int, axis: str, size: int) -> bool:
        i = off + (rel_idx % len(body))
        if specs[i] is None and _divides(shape[i], size):
            specs[i] = axis
            return True
        return False

    # The leading group axis of stacked leaves is never sharded here.
    is_stacked = any(seg in path for seg in ("blocks/", "cross/", "encoder/blocks"))
    if is_stacked and len(body) >= 1:
        off += 1
        body = body[1:]
        if not body:
            return P(*specs)

    if len(body) == 1:
        return P(*specs)  # norms / biases / small vectors: replicate

    if path.endswith("embed"):
        # Token-gather tables: shard d_model only.
        try_set(-1, "model", model)
        return P(*specs)

    if "/moe/" in path:
        name = path.rsplit("/", 1)[-1]
        if name == "router":  # (d, E)
            try_set(-1, "model", model)
            if data_free:
                try_set(0, "data", data)
            return P(*specs)
        if name in ("w_gate", "w_in", "w_out") and len(body) == 3:  # (E, d|ff, ff|d)
            try_set(0, "model", model)  # expert parallelism
            if data_free:
                rel = 1 if shape[off + 1] >= shape[off + 2] else 2
                try_set(rel, "data", data)
            return P(*specs)
        # the dense-residual ffn inside moe falls through to the generic rule

    last = body[-1]
    if last == cfg.d_model and len(body) >= 2:
        # out-projection (X, d): TP on X (row-parallel), FSDP on d.
        try_set(-2, "model", model)
        if data_free:
            try_set(-1, "data", data)
    else:
        # in-projection (d, X) or embedding (V, d-like): TP on the last dim.
        try_set(-1, "model", model)
        if data_free:
            try_set(-2, "data", data)
    return P(*specs)


def param_shardings(
    shapes_tree: PyTree,
    cfg: ArchConfig,
    mesh,
    *,
    num_nodes: int | None = None,
) -> PyTree:
    """Spec tree for a param (or optimizer-state) tree of tensors (``meta``
    tensors will do). num_nodes=None -> serving layout (no node axis)."""
    has_node = num_nodes is not None
    naxes = node_axes_for(num_nodes, mesh) if has_node else ()
    return tree_map_with_path(
        lambda path, leaf: leaf_spec(_path_str(path), tuple(leaf.shape), cfg, mesh,
                                     node_axes=naxes, has_node_axis=has_node),
        shapes_tree,
    )


def batch_shardings(
    shapes_tree: PyTree,
    mesh,
    *,
    num_nodes: int,
    layout: str = "tp",
) -> PyTree:
    """Train inputs (M, N, B, ...): microbatch axis unsharded, node axis over
    its mesh axes, per-node batch over whatever of ("pod","data") the node
    axis left unused, plus "model" in the fsdp_model layout."""
    naxes = node_axes_for(num_nodes, mesh)
    free = tuple(a for a in ("pod", "data") if a in mesh.shape and a not in naxes)
    if layout == "fsdp_model":
        free = free + ("model",)

    def one(_path, leaf):
        b = leaf.shape[2]
        bspec = None
        if free:
            prod = 1
            used = []
            for a in free:
                if b % (prod * mesh.shape[a]) == 0:
                    used.append(a)
                    prod *= mesh.shape[a]
            bspec = tuple(used) if used else None
        return P(*([None, naxes if naxes else None, bspec] + [None] * (leaf.ndim - 3)))

    return tree_map_with_path(one, shapes_tree)


def decode_shardings(inputs: dict, cfg: ArchConfig, mesh) -> dict:
    """Serve-step inputs: token (B,) batch over "data" when divisible;
    attention caches (G, B, T, hkv, hd) batch over "data" and cache seq over
    "model"; recurrent states batch over "data", inner dim over "model";
    memory (B, T, d) batch over "data"."""
    data = mesh.shape.get("data", 1)
    model = mesh.shape.get("model", 1)

    def bspec(b):
        return "data" if b % data == 0 else None

    def cache_leaf(path, leaf):
        pstr = _path_str(path)
        shp = leaf.shape
        if pstr.endswith("index") or leaf.ndim <= 1:
            return P()
        specs: list = [None] * leaf.ndim
        specs[1] = bspec(shp[1])
        if pstr.endswith("/k") or pstr.endswith("/v"):
            if shp[2] % model == 0:
                specs[2] = "model"  # cache seq dim
        elif pstr.endswith("ssm") or pstr.endswith("conv"):
            di_idx = 2 if pstr.endswith("ssm") else 3
            if shp[di_idx] % model == 0:
                specs[di_idx] = "model"
        elif pstr.endswith("wkv"):
            if shp[2] % model == 0:
                specs[2] = "model"  # heads
        elif pstr.endswith("shift"):
            if shp[2] % model == 0:
                specs[2] = "model"  # d_model
        return P(*specs)

    out: dict = {}
    for k, v in inputs.items():
        if k == "cache":
            out[k] = tree_map_with_path(cache_leaf, v)
        elif k == "token":
            out[k] = P(bspec(v.shape[0]))
        else:  # memory / frames: (B, T, d)
            out[k] = P(bspec(v.shape[0]), None, None)
    return out


def prefill_shardings(inputs: dict, mesh) -> dict:
    """Prefill inputs: the batch dim over "data" when divisible."""
    data = mesh.shape.get("data", 1)

    def one(_path, leaf):
        b = leaf.shape[0]
        return P(*(["data" if b % data == 0 else None] + [None] * (leaf.ndim - 1)))

    return {k: tree_map_with_path(one, v) for k, v in inputs.items()}


def local_slab(x: torch.Tensor, spec, mesh, position: dict[str, int]) -> torch.Tensor:
    """The slab of the global tensor ``x`` held at mesh ``position`` (axis
    name -> index) under ``spec``: each sharded dimension cut into equal
    blocks, block ``axis_index`` of its axes. A view of ``x``; a spec shorter
    than ``x.ndim`` leaves the trailing dimensions whole."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = axes_of(entry)
        n = axis_size(mesh, axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split {n} ways")
        blk = x.shape[dim] // n
        x = x.narrow(dim, axis_index(mesh, axes, position) * blk, blk)
    return x


def map_specs(fn, tree: PyTree, specs: PyTree, _path: tuple = ()) -> PyTree:
    """``fn(path, leaf, spec)`` over a tree and its tree of specs, whose
    ``PartitionSpec`` leaves are tuples and so are not walked into; None
    (an empty subtree) stays None."""
    if tree is None:
        return None
    if isinstance(specs, PartitionSpec):
        return fn(_path, tree, specs)
    if isinstance(tree, dict):
        return {k: map_specs(fn, tree[k], specs[k], _path + (k,)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [map_specs(fn, t, s, _path + (i,)) for i, (t, s) in enumerate(zip(tree, specs))]
    raise TypeError(f"{'/'.join(map(str, _path))}: a {type(tree).__name__} against {specs!r}")


def _blocks(spec, mesh, position: dict[str, int]) -> tuple:
    """Which block of each sharded dimension ``position`` holds."""
    return tuple(axis_index(mesh, axes_of(e), position) if e is not None else None
                 for e in spec)


class Placed:
    """A tree placed over a mesh: ``at(coord)`` is the tree of slabs that the
    mesh position ``coord`` (a tuple of indices, in axis order, one of
    ``coords``) holds, each on that position's device. ``specs`` and
    ``mesh`` are those it was placed by."""

    def __init__(self, mesh, specs: PyTree, leaves: PyTree, coords: list[tuple]):
        self.mesh, self.specs, self._leaves = mesh, specs, leaves
        self.coords = coords
        self._trees = {c: map_specs(lambda _p, per, _s, i=i: per[i], leaves, specs)
                       for i, c in enumerate(coords)}

    def at(self, coord: tuple) -> PyTree:
        return self._trees[tuple(coord)]

    def tensors(self) -> list[torch.Tensor]:
        """Every distinct slab once."""
        seen: dict[int, torch.Tensor] = {}
        map_specs(lambda _p, per, _s: [seen.setdefault(id(t), t) for t in per],
                  self._leaves, self.specs)
        return list(seen.values())


def _coords(mesh) -> list[tuple]:
    return list(itertools.product(*(range(n) for n in mesh.devices.shape)))


def place(tree: PyTree, specs: PyTree, mesh) -> Placed:
    """Every mesh position's ``local_slab`` of every leaf of the global
    ``tree`` under ``specs``, on the position's device. Where that device is
    the leaf's own the slab is a view of it (writes go through); elsewhere it
    is a copy, and positions of one device that hold the same block (the
    spec replicates it along their axes) share one tensor, so no device
    holds a slab twice."""
    coords = _coords(mesh)

    def one(_path, x, spec):
        made: dict[tuple, torch.Tensor] = {}
        per = []
        for c in coords:
            pos = dict(zip(mesh.axis_names, c))
            dev = mesh.devices[c]
            key = (str(dev), _blocks(spec, mesh, pos))
            if key not in made:
                slab = local_slab(x, spec, mesh, pos)
                made[key] = slab if same_device(slab.device, dev) else slab.to(dev, copy=True)
            per.append(made[key])
        return per

    return Placed(mesh, specs, map_specs(one, tree, specs), coords)


def global_view(placed: Placed, device=None) -> PyTree:
    """The global tree a ``Placed`` holds, each leaf a new tensor on
    ``device`` (None: the device of position 0), its blocks copied from the
    positions that hold them."""
    mesh, coords = placed.mesh, placed.coords

    def one(_path, per, spec):
        first = per[0]
        shape = list(first.shape)
        for dim, entry in enumerate(spec):
            if entry is not None:
                shape[dim] *= axis_size(mesh, axes_of(entry))
        out = torch.empty(shape, dtype=first.dtype,
                          device=first.device if device is None else device)
        done = set()
        for c, slab in zip(coords, per):
            pos = dict(zip(mesh.axis_names, c))
            key = _blocks(spec, mesh, pos)
            if key not in done:
                done.add(key)
                local_slab(out, spec, mesh, pos).copy_(slab)
        return out

    return map_specs(one, placed._leaves, placed.specs)
