"""Faults planted in the program underneath the timed path, for the checks
that the comparison catches them (``bench/calibrate.py`` on the card,
``bench/tests`` on the CPU). The benchmark's own runs never import this.

- ``still``: a local step that returns its state unchanged.
- ``half``: half of every batch left out, the loss's mean taken over the rest.
- ``exchange``: the halo exchange between shards left out (a sharded run's
  receive buffers keep what they held).
- ``wmix``: every entry of the mixing matrix one float32 step too large.
- ``stale``: every round of a chunk takes the chunk's first row of batch
  positions (an unsharded run), so a refilled round trains on its
  predecessor's batches.
"""

from __future__ import annotations

import contextlib

import numpy as np

__all__ = ["FAULTS", "planted"]

FAULTS = ("still", "half", "exchange", "wmix", "stale")


def _half(batch_at):
    def cut(self, idx):
        x, y = batch_at(self, idx)
        keep = y.shape[-1] // 2
        return x[..., :keep, :], y[..., :keep]
    return cut


def _up(values: np.ndarray) -> np.ndarray:
    v = np.asarray(values, dtype=np.float32)
    return np.where(v != 0, np.nextafter(v, np.float32(np.inf)), v)


@contextlib.contextmanager
def planted(fault: str | None):
    """The program with ``fault`` planted for the block (None: as it is)."""
    if fault is None:
        yield
        return
    import dataclasses

    from repro_torch.core import mixing, sparse
    from repro_torch.data import loader
    from repro_torch.train import trainer as T

    patches = []
    if fault == "still":
        patches.append((T.DecentralizedTrainer, "_sgd_step",
                        lambda self, params, momentum, x, y: None))
    elif fault == "half":
        patches += [(loader.NodeLoader, "batch_at", _half(loader.NodeLoader.batch_at)),
                    (loader.ShardData, "batch_at", _half(loader.ShardData.batch_at))]
    elif fault == "exchange":
        patches.append((T._ShardedFusedRounds, "_exchange", lambda self, t: None))
    elif fault == "stale":
        first_row = T._FusedRounds.round
        patches.append((T._FusedRounds, "round", lambda self, r, i: first_row(self, r, 0)))
    elif fault == "wmix":
        dense, csr = mixing.decavg_matrix, sparse.csr_from_graph
        patches += [
            (mixing, "decavg_matrix",
             lambda *a, **k: _up(dense(*a, **k)).astype(np.float64)),
            (sparse, "csr_from_graph",
             lambda *a, **k: dataclasses.replace(c := csr(*a, **k), values=_up(c.values))),
        ]
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    try:
        for obj, name, new in patches:
            setattr(obj, name, new)
        yield
    finally:
        for obj, name, old in saved:
            setattr(obj, name, old)
