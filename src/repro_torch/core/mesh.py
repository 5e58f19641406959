"""A mesh of devices in one process, for the node-sharded gossip backends.

The reference runs ``sharded``, ``sparse_sharded`` and ``permute`` under
``shard_map`` over a ``jax.sharding.Mesh``, with four ``jax.lax``
collectives (``all_gather``, ``psum_scatter``, ``ppermute``,
``axis_index``); the pipeline decoders add ``psum`` over one axis and a
tiled ``all_gather`` of a feature axis. No module of the reference corresponds to this one: it is
the port's stand-in for that mesh and those collectives, and it is not the
counterpart of ``repro/launch/mesh.py`` (production meshes, a later slice).

One process drives every shard, as the reference's single controller does.
A mixing function splits the node axis into S slabs, runs its per-shard body
on each slab in shard order, and the collectives below are plain functions
over the list of per-shard tensors: each moves a tensor to the receiving
shard's device with an explicit ``.to(device)``. The same device may repeat
(``Mesh([torch.device("cpu")] * 8, ("data",))``, or eight shards on one
card): that is how S > 1 runs on one device, as the reference's tests run
8 fake CPU devices. The shards' devices may also differ (a shard per
card): the same code then copies between cards, and only in the
collectives.

``scatter`` and ``gather`` put a node-stacked tensor into per-shard slabs
and back, at the start and end of a run that keeps its state sharded; they
are not collectives of a round.

The collectives keep a tally of the bytes they move from one shard to a
different shard (``wire_bytes``, ``reset_wire_bytes``), by shard index
whatever the devices are, so it reads the same on one device as across
cards. It is the port's run-time stand-in for the reference's count of
collective bytes in compiled HLO (``analysis.collective_wire_bytes`` over
``launch/hlo_walk.py``, which parse XLA's HLO text and are not ported),
keyed by the same kinds: ``all-gather``, ``all-reduce`` (``psum``),
``reduce-scatter`` (``psum_scatter``) and ``collective-permute``
(``ppermute``). The reference counts one device's wire; the tally sums over
the shards what the port's own schedule moves: ``psum`` adds the parts on
shard 0 and hands the sum back, 2 (n - 1) parts' bytes for n shards.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = [
    "Mesh",
    "local_mesh",
    "axes_of",
    "axis_size",
    "axis_index",
    "all_gather",
    "psum",
    "psum_rows",
    "psum_scatter",
    "ppermute",
    "same_device",
    "scatter",
    "gather",
    "WIRE_KINDS",
    "wire_bytes",
    "reset_wire_bytes",
]

WIRE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "collective-permute")
_WIRE = dict.fromkeys(WIRE_KINDS, 0)


def wire_bytes() -> dict[str, int]:
    """Bytes the collectives moved between shards since the last reset, by
    kind."""
    return dict(_WIRE)


def reset_wire_bytes() -> None:
    for kind in WIRE_KINDS:
        _WIRE[kind] = 0


def _tally(kind: str, t: torch.Tensor, times: int = 1) -> None:
    _WIRE[kind] += times * t.numel() * t.element_size()


def _canonical(device: torch.device | str) -> torch.device:
    """``device`` with a CUDA index filled in (``cuda`` is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def same_device(a: torch.device | str, b: torch.device | str) -> bool:
    """Whether ``a`` and ``b`` name the same device (``cuda`` == ``cuda:0``
    when card 0 is current)."""
    return _canonical(a) == _canonical(b)


class Mesh:
    """An array of ``torch.device`` with named axes, as ``jax.sharding.Mesh``.

    ``mesh.shape`` maps axis name to size, so ``mesh.shape["data"]`` reads
    as in JAX; ``devices`` is the numpy object array of devices.
    """

    def __init__(self, devices, axis_names):
        if isinstance(axis_names, str):
            axis_names = (axis_names,)
        self.devices = np.vectorize(_canonical, otypes=[object])(np.asarray(devices, dtype=object))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"mesh of shape {self.devices.shape} needs {self.devices.ndim} axis "
                f"names, got {self.axis_names}"
            )
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_set(self) -> set[torch.device]:
        return set(self.devices.ravel())

    def shard_devices(self, axes) -> list[torch.device]:
        """The device of each shard of an array split over ``axes``, in
        shard order (``axis_index``); axes not in ``axes`` replicate the
        array, and their first device along each such axis is used."""
        axes = axes_of(axes)
        out: list[torch.device | None] = [None] * axis_size(self, axes)
        for coord in itertools.product(*(range(n) for n in self.devices.shape)):
            pos = dict(zip(self.axis_names, coord))
            if any(pos[a] for a in self.axis_names if a not in axes):
                continue
            out[axis_index(self, axes, pos)] = self.devices[coord]
        return out

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, devices={sorted({str(d) for d in self.devices.ravel()})})"


def local_mesh(node_axis: str = "data", *, device=None, shards: int | None = None) -> Mesh:
    """A 1-D mesh over ``node_axis``: one shard per local CUDA card when
    ``device`` is CUDA (None means CUDA, and raises without a card), one
    shard on the CPU. ``shards`` asks for that many shards on ``device``
    itself instead."""
    dev = resolve_device(device)
    if shards is not None:
        devices = [dev] * int(shards)
    elif dev.type == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    return Mesh(devices, (node_axis,))


def axes_of(node_axis) -> tuple[str, ...]:
    """A node axis given as one name or a tuple of names, as a tuple."""
    return (node_axis,) if isinstance(node_axis, str) else tuple(node_axis)


def axis_size(mesh, node_axis) -> int:
    """Shards along ``node_axis`` (the product over a tuple of axes). Reads
    only ``mesh.shape``."""
    size = 1
    for a in axes_of(node_axis):
        size *= mesh.shape[a]
    return size


def axis_index(mesh, node_axis, position: dict[str, int]) -> int:
    """The shard index of the mesh position ``position`` (axis -> index)
    along ``node_axis``: row-major over its axes, as ``jax.lax.axis_index``."""
    idx = 0
    for a in axes_of(node_axis):
        idx = idx * mesh.shape[a] + int(position[a])
    return idx


def scatter(x: torch.Tensor, devices: list[torch.device]) -> list[torch.Tensor]:
    """A node-stacked tensor cut into one row block per shard, each a tensor
    of its own on its shard's device (a copy, also where the device is
    ``x``'s): the slabs a sharded run holds its state in."""
    shards = len(devices)
    if x.shape[0] % shards:
        raise ValueError(f"node axis {x.shape[0]} not divisible by {shards} shards")
    blk = x.shape[0] // shards
    return [x[s * blk:(s + 1) * blk].to(d, copy=True) for s, d in enumerate(devices)]


def gather(slabs: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Per-shard slabs back on one device, concatenated in shard order (the
    inverse of ``scatter``)."""
    return torch.cat([s.to(device) for s in slabs])


def all_gather(slabs: list[torch.Tensor], device: torch.device, *, axis: int = 0,
               shard: int | None = None) -> torch.Tensor:
    """Every shard's slab on ``device``, concatenated in shard order along
    tensor axis ``axis``: the full node axis by default, a feature axis for
    ``jax.lax.all_gather(..., axis=axis, tiled=True)``. ``shard``: the
    receiving shard, whose own slab does not cross; without it every slab is
    tallied."""
    for i, s in enumerate(slabs):
        if i != shard:
            _tally("all-gather", s)
    return torch.cat([s.to(device) for s in slabs], dim=axis)


def psum(parts: list[torch.Tensor], devices: list[torch.device]) -> list[torch.Tensor]:
    """``jax.lax.psum`` over one mesh axis: the sum of the shards' ``parts``,
    added in shard order, given to each shard on ``devices[i]``. Shards on
    one device share the one result tensor."""
    acc = parts[0].to(devices[0])
    for p in parts[1:]:
        _tally("all-reduce", p)
        acc = acc + p.to(devices[0])
    _tally("all-reduce", acc, len(devices) - 1)
    return [acc.to(d) for d in devices]


def psum_rows(slabs: list[torch.Tensor], devices: list[torch.device]) -> list[torch.Tensor]:
    """``psum`` of the shards' row sums, added one row at a time in row
    order, the running sum carried from each shard to the next: the bits do
    not depend on how the rows are split into shards. Each shard gets the
    (...) total on ``devices[i]``; the tally is ``psum``'s, 2 (n - 1) rows'
    bytes."""
    acc = None
    for x, d in zip(slabs, devices):
        if acc is not None:
            _tally("all-reduce", acc)
            acc = acc.to(d)
        for row in x:
            acc = row.clone() if acc is None else acc + row
    _tally("all-reduce", acc, len(devices) - 1)
    return [acc.to(d) for d in devices]


def psum_scatter(parts: list[torch.Tensor], devices: list[torch.device]) -> list[torch.Tensor]:
    """Sum the shards' (n, ...) ``parts`` and give shard i its row block
    i of the sum, on ``devices[i]``. The sum runs in shard order."""
    shards = len(parts)
    blk = parts[0].shape[0] // shards
    out = []
    for i, dev in enumerate(devices):
        acc = parts[0][i * blk:(i + 1) * blk].to(dev, copy=True)
        for p in parts[1:]:
            acc.add_(p[i * blk:(i + 1) * blk].to(dev))
        _tally("reduce-scatter", acc, shards - 1)
        out.append(acc)
    return out


def ppermute(
    slabs: list[torch.Tensor], pairs, devices: list[torch.device]
) -> list[torch.Tensor]:
    """Shard ``dst`` receives shard ``src``'s slab for each ``(src, dst)``
    of ``pairs`` (each destination at most once); a shard that receives
    nothing gets zeros, as ``jax.lax.ppermute`` gives."""
    got: list[torch.Tensor | None] = [None] * len(slabs)
    for src, dst in pairs:
        if src != dst:
            _tally("collective-permute", slabs[src])
        got[dst] = slabs[src].to(devices[dst])
    return [
        g if g is not None else torch.zeros_like(slabs[i], device=devices[i])
        for i, g in enumerate(got)
    ]
