"""Named meshes: the production layouts and small host meshes.

The port of ``repro/launch/mesh.py``. A mesh is a ``core.mesh.Mesh``: an
array of ``torch.device`` with named axes, where one device may repeat, so
the reference's 256- and 512-device layouts are laid over one card (or the
CPU) and the slab of every mesh position is a view of the global tensor.
The reference's roofline constants are for its own hardware and are left
out here.
"""

from __future__ import annotations

import numpy as np

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
]

SINGLE_POD_SHAPE = (16, 16)
SINGLE_POD_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def _repeated(shape: tuple[int, ...], axes: tuple[str, ...], device) -> Mesh:
    devices = np.empty(tuple(shape), dtype=object)
    devices.fill(resolve_device(device))
    return Mesh(devices, tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``, every position on ``device`` (None: the
    card)."""
    shape = MULTI_POD_SHAPE if multi_pod else SINGLE_POD_SHAPE
    axes = MULTI_POD_AXES if multi_pod else SINGLE_POD_AXES
    return _repeated(shape, axes, device)


def make_host_mesh(shape=(2, 2), axes=("data", "model"), device=None) -> Mesh:
    """A small mesh with ``device`` (None: the card) at every position, as
    ``core.mesh.local_mesh(shards=)`` builds a 1-D one."""
    return _repeated(tuple(shape), tuple(axes), device)


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
