"""The run's random draws: one member's initial weights and every round's
batch positions.

- Weights: He-initialised (a normal scaled by sqrt(2 / fan_in)) with zero
  biases, drawn on the run's device in one call from a ``torch.Generator``
  seeded from the run's seed. Every node starts from this one member, as
  the paper's runs do.
- Batch positions: for call ``c`` of a run and its round ``r``, a
  (steps, N, B) array of with-replacement positions into each node's own
  pool, from numpy seeded with (seed, c, r). Each call of the timed window
  draws fresh batches; call 0 is the set-up's.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["init_member", "batch_positions", "local_steps"]


def _seed(*words: int) -> int:
    return int(np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0] >> 1)


def init_member(seed: int, dims: Sequence[int], device: torch.device) -> list[dict[str, torch.Tensor]]:
    """One member's layers ``[{"w": (a, b), "b": (b,)}, ...]`` for widths
    ``dims`` (input, hidden..., classes), in f32 on ``device``."""
    sizes = [a * b for a, b in zip(dims[:-1], dims[1:])]
    gen = torch.Generator(device=device).manual_seed(_seed(seed, 3))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    layers, at = [], 0
    for (a, b), k in zip(zip(dims[:-1], dims[1:]), sizes):
        w = flat[at:at + k].view(a, b) * (2.0 / a) ** 0.5
        layers.append({"w": w, "b": torch.zeros(b, device=device)})
        at += k
    return layers


def local_steps(sizes: np.ndarray, batch: int) -> int:
    """Local steps a round: one pass of the median node's data."""
    return max(1, int(np.median(sizes)) // batch)


def batch_positions(seed: int, call: int, round_: int, sizes: np.ndarray, steps: int,
                    batch: int) -> np.ndarray:
    """(steps, N, B) int64 positions, each in [0, sizes[n])."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 4, call, round_]))
    raw = rng.integers(0, 2**31 - 1, size=(steps, len(sizes), batch), dtype=np.int64)
    return raw % np.asarray(sizes, dtype=np.int64)[None, :, None]
