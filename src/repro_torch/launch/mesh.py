"""Named meshes: the production layouts and small host meshes.

The port of ``repro/launch/mesh.py``. A mesh is a ``core.mesh.Mesh``: an
array of ``torch.device`` with named axes, where one device may repeat. By
default every position is one device, so the reference's 256- and
512-device layouts are laid over one card (or the CPU, or the ``meta``
device of the dry-run) and the slab of every mesh position is a view of the
global tensor. Given ``devices``, the positions are laid over those cards
as the reference's ``jax.make_mesh`` lays them over the local devices:
row-major, the leading axes (``pod``, ``data``) outermost, and where there
are fewer cards than positions each card holds a run of consecutive
positions, so the ranks of one stage share a card before stages do.

``H100`` holds the per-card rates that ``analysis.Roofline.finalize``
divides by, for one NVIDIA H100 SXM5 (700 W) from NVIDIA's H100 Tensor Core
GPU datasheet: dense BF16 tensor-core peak 989.4e12 FLOP/s (the datasheet's
1,979 TFLOPS is with 2:4 sparsity) and HBM3 3.35e12 B/s. The link is the
slowest one a 256-card mesh crosses: NVLink 4 joins the 8 cards of one
node (DGX H100), so a (16, 16) mesh spans 32 nodes, and between nodes each
card has one ConnectX-7 NDR InfiniBand port of 400 Gb/s (the DGX H100 user
guide), 50e9 B/s a card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.mesh import Mesh
from repro_torch.device import resolve_device

__all__ = [
    "SINGLE_POD_SHAPE",
    "SINGLE_POD_AXES",
    "MULTI_POD_SHAPE",
    "MULTI_POD_AXES",
    "make_production_mesh",
    "make_host_mesh",
    "node_axes_for",
    "Hardware",
    "H100",
]

SINGLE_POD_SHAPE = (16, 16)
SINGLE_POD_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


class Hardware(NamedTuple):
    """Per-card rates of the roofline: FLOP/s, HBM B/s, link B/s."""

    peak_flops_bf16: float
    hbm_bw: float
    link_bw: float


H100 = Hardware(peak_flops_bf16=989.4e12, hbm_bw=3.35e12, link_bw=50e9)


def _laid(shape: tuple[int, ...], axes: tuple[str, ...], device, devices) -> Mesh:
    """Position k (row-major) on card k * n // positions of the first n =
    min(len(devices), positions) of ``devices``; every position on
    ``device`` (None: the card) when ``devices`` is None."""
    positions = int(np.prod(shape))
    if devices is None:
        flat = [resolve_device(device)] * positions
    else:
        if device is not None:
            raise ValueError("give device or devices, not both")
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("devices is empty")
        n = min(len(devices), positions)
        flat = [devices[k * n // positions] for k in range(positions)]
    grid = np.empty(positions, dtype=object)
    grid[:] = flat
    return Mesh(grid.reshape(tuple(shape)), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None, devices=None) -> Mesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``, every position on ``device`` (None: the
    card), or laid over the cards ``devices``."""
    shape = MULTI_POD_SHAPE if multi_pod else SINGLE_POD_SHAPE
    axes = MULTI_POD_AXES if multi_pod else SINGLE_POD_AXES
    return _laid(shape, axes, device, devices)


def make_host_mesh(shape=(2, 2), axes=("data", "model"), device=None, *, devices=None) -> Mesh:
    """A small mesh with ``device`` (None: the card) at every position, as
    ``core.mesh.local_mesh(shards=)`` builds a 1-D one, or laid over the
    cards ``devices`` (for example ``(4, 2)`` over four cards puts stage s on
    ``cuda:s``, both its ranks there)."""
    return _laid(tuple(shape), tuple(axes), device, devices)


def node_axes_for(num_nodes: int, mesh) -> tuple[str, ...]:
    """Longest prefix of ("pod","data") mesh axes the node axis shards over.

    Small archs: num_nodes == pod*data -> fully sharded gossip. Big archs:
    num_nodes == pods (or 1) -> gossip over the `pod` axis only, params FSDP
    elsewhere. Reads only ``mesh.shape``.
    """
    out: list[str] = []
    prod = 1
    for a in ("pod", "data"):
        if a not in mesh.shape:
            continue
        nxt = prod * mesh.shape[a]
        if num_nodes % nxt == 0:
            out.append(a)
            prod = nxt
        else:
            break
    return tuple(out)
