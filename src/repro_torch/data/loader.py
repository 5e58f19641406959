"""Per-node batching from a dataset staged on the device once.

Every local step sees a uniform (N, B, ...) batch: each node samples with
replacement from its own pool (its rows of the shared dataset), and the
number of local steps per round is one pass of the *median* node's data, as
in the reference's ``NodeLoader``.

The dataset lives on the device as an image bank ``x`` (T, D), labels ``y``
(T,), the zero-padded per-node pools ``parts`` (N, M) and their true
``sizes`` (N,), so batches are gathered on the card. (The reference's
host-side ``sample_round`` builds a (steps, N, B, 784) array on the host
every round.)

Batch indices are a pure function of ``(seed, round)``: each round seeds a
``torch.Generator`` on the loader's device from the pair. The draws differ
from the reference's JAX threefry bits; ``index_fn`` lets a caller supply the
pool positions instead (the parity tests inject the reference's
``round_batch_indices`` through it).

The per-round loop draws a round's indices as it goes (``batches``); the
fused path draws a whole chunk's up front (``chunk_indices``), the same
draws round by round, because a seeded generator cannot run inside a CUDA
graph capture: the captured round reads them from a static buffer and
gathers its batches with ``batch_at``, as ``batches`` does.

A run that keeps its nodes sharded over several devices stages the data
per shard once (``shard_data``): the image bank and labels on each shard's
device and the pools of the nodes it owns. The chunk's positions are still
drawn on the loader's device, and each shard takes its nodes' rows of
them, as the reference slices its replicated draws per slab.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

__all__ = ["NodeLoader", "ShardData"]

# index_fn(round, steps) -> (steps, N, B) pool positions, each in [0, sizes[n]).
IndexFn = Callable[[int, int], np.ndarray]


class NodeLoader:
    def __init__(
        self,
        x: np.ndarray,
        y: np.ndarray,
        parts: list[np.ndarray],
        *,
        batch_size: int,
        seed: int = 0,
        device: str | torch.device,
        index_fn: IndexFn | None = None,
    ):
        self.device = torch.device(device)
        self.batch = batch_size
        self.seed = seed
        self.index_fn = index_fn
        self.num_nodes = len(parts)
        self.sizes = np.array([len(p) for p in parts], dtype=np.int64)
        empty = np.flatnonzero(self.sizes == 0)
        if empty.size:
            raise ValueError(f"node {int(empty[0])} has an empty dataset")
        pools = np.zeros((self.num_nodes, int(self.sizes.max())), dtype=np.int64)
        for n, p in enumerate(parts):
            pools[n, : len(p)] = p
        self.x = torch.as_tensor(np.ascontiguousarray(x), device=self.device)
        self.y = torch.as_tensor(np.asarray(y, dtype=np.int64), device=self.device)
        self.parts = torch.as_tensor(pools, device=self.device)
        self._sizes = torch.as_tensor(self.sizes, device=self.device)

    def steps_per_epoch(self) -> int:
        """Uniform local steps per round: one pass of the *median* node."""
        return max(1, int(np.median(self.sizes)) // self.batch)

    def round_indices(self, round: int, steps: int) -> torch.Tensor:
        """(steps, N, B) with-replacement pool positions for one round."""
        if self.index_fn is not None:
            idx = torch.as_tensor(np.array(self.index_fn(round, steps)), device=self.device)
            return idx.long()
        seed = int(np.random.SeedSequence([self.seed, round]).generate_state(1, np.uint64)[0])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        raw = torch.randint(
            0, 2**31 - 1, (steps, self.num_nodes, self.batch),
            generator=gen, device=self.device,
        )
        return raw % self._sizes[None, :, None]

    def chunk_indices(self, start: int, length: int, steps: int) -> torch.Tensor:
        """(length, steps, N, B): ``round_indices`` of rounds start..start+length-1."""
        return torch.stack([self.round_indices(r, steps) for r in range(start, start + length)])

    def batch_at(self, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The (x (N, B, ...), y (N, B)) batch at pool positions ``idx`` (N, B)."""
        rows = torch.gather(self.parts, 1, idx)  # (N, B) dataset rows
        return self.x[rows], self.y[rows]

    def shard_data(self, devices: list[torch.device]) -> list["ShardData"]:
        """The dataset staged for a run sharded over ``devices`` (shard s
        owns nodes ``[s*blk, (s+1)*blk)``): the bank and labels copied once
        to each distinct device (the loader's own tensors on its device),
        and each shard's rows of the pools."""
        shards = len(devices)
        if self.num_nodes % shards:
            raise ValueError(f"{self.num_nodes} nodes not divisible by {shards} shards")
        blk = self.num_nodes // shards
        banks: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}
        out = []
        for s, dev in enumerate(devices):
            dev = torch.device(dev)
            if dev not in banks:
                banks[dev] = (self.x.to(dev), self.y.to(dev))
            x, y = banks[dev]
            out.append(ShardData(x, y, self.parts[s * blk:(s + 1) * blk].to(dev, copy=True)))
        return out

    def batches(self, round: int, steps: int):
        """Yield ``steps`` (x (N, B, ...), y (N, B)) batches of one round."""
        idx = self.round_indices(round, steps)
        for s in range(steps):
            yield self.batch_at(idx[s])


@dataclasses.dataclass(frozen=True)
class ShardData:
    """One shard's view of a loader's dataset, on the shard's device: the
    bank ``x``, labels ``y`` and its nodes' pools ``parts`` (blk, M)."""

    x: torch.Tensor
    y: torch.Tensor
    parts: torch.Tensor

    def batch_at(self, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The shard's (x (blk, B, ...), y (blk, B)) batch at its pool
        positions ``idx`` (blk, B), as ``NodeLoader.batch_at``."""
        rows = torch.gather(self.parts, 1, idx)
        return self.x[rows], self.y[rows]
