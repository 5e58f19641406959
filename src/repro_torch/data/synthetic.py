"""Deterministic MNIST-like synthetic dataset.

The container is offline (no MNIST download — the repro=2 data gate, see
DESIGN.md §2), so the reproduction uses a *structured* stand-in with the same
interface: 10 classes, 784-dim inputs in [0, 1], train/test splits.

Construction: each class c gets a fixed random prototype p_c (seeded
independently of the sampling seed) plus a class-specific low-rank "style"
subspace B_c; a sample is  clip(p_c + B_c z + eps)  with z ~ N(0, I_r),
eps ~ N(0, sigma^2).  Within-class variation is real (an MLP must learn more
than a nearest-prototype rule, and test accuracy saturates below 100%), and
classes a node never sees are unpredictable without gossip — which is the
property the paper's knowledge-spread experiments need.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Dataset", "make_mnist_like"]

_PROTO_SEED = 1234567


@dataclasses.dataclass(frozen=True)
class Dataset:
    x_train: np.ndarray  # (Ntr, 784) float32 in [0, 1]
    y_train: np.ndarray  # (Ntr,) int64
    x_test: np.ndarray
    y_test: np.ndarray

    @property
    def num_classes(self) -> int:
        return int(self.y_train.max()) + 1


def _prototypes(num_classes: int, dim: int, rank: int, contrast: float, style: float):
    rng = np.random.default_rng(_PROTO_SEED)
    # Smooth-ish prototypes: random low-frequency mixtures, scaled into [0,1]
    # and contrast-compressed so classes overlap (a ridge probe lands at
    # ~0.82 test accuracy — learnable but not linearly trivial, like MNIST).
    base = rng.normal(size=(num_classes, dim))
    kernel = np.exp(-0.5 * (np.arange(-10, 11) / 4.0) ** 2)
    kernel /= kernel.sum()
    smooth = np.stack([np.convolve(b, kernel, mode="same") for b in base])
    protos = (smooth - smooth.min()) / (smooth.max() - smooth.min())
    protos = 0.5 + contrast * (protos - 0.5)
    styles = rng.normal(size=(num_classes, dim, rank)) * style
    return protos.astype(np.float32), styles.astype(np.float32)


def make_mnist_like(
    *,
    train_per_class: int = 500,
    test_per_class: int = 100,
    dim: int = 784,
    num_classes: int = 10,
    rank: int = 8,
    noise: float = 0.25,
    contrast: float = 0.4,
    style: float = 0.25,
    seed: int = 0,
) -> Dataset:
    protos, styles = _prototypes(num_classes, dim, rank, contrast, style)
    rng = np.random.default_rng(seed)

    def sample(per_class: int):
        xs, ys = [], []
        for c in range(num_classes):
            z = rng.normal(size=(per_class, rank)).astype(np.float32)
            eps = rng.normal(scale=noise, size=(per_class, dim)).astype(np.float32)
            x = protos[c][None] + z @ styles[c].T + eps
            xs.append(np.clip(x, 0.0, 1.0))
            ys.append(np.full(per_class, c, dtype=np.int64))
        x = np.concatenate(xs)
        y = np.concatenate(ys)
        perm = rng.permutation(len(y))
        return x[perm], y[perm]

    x_tr, y_tr = sample(train_per_class)
    x_te, y_te = sample(test_per_class)
    return Dataset(x_tr, y_tr, x_te, y_te)
