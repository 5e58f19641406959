"""The MNIST-like data set, made from the run's seed.

A frozen copy of the repository's MNIST-like construction (ten classes, each
a fixed smooth prototype plus a class-specific low-rank style subspace and
pixel noise, clipped to [0, 1]): the prototypes come from one fixed seed,
every sample from the run's seed. Only numpy; nothing of the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Dataset", "make_mnist_like"]

_PROTO_SEED = 1234567


@dataclasses.dataclass(frozen=True)
class Dataset:
    x_train: np.ndarray  # (T_train, dim) float32 in [0, 1]
    y_train: np.ndarray  # (T_train,) int64
    x_test: np.ndarray
    y_test: np.ndarray

    @property
    def num_classes(self) -> int:
        return int(self.y_train.max()) + 1


def _prototypes(num_classes: int, dim: int, rank: int, contrast: float, style: float):
    rng = np.random.default_rng(_PROTO_SEED)
    base = rng.normal(size=(num_classes, dim))
    kernel = np.exp(-0.5 * (np.arange(-10, 11) / 4.0) ** 2)
    kernel /= kernel.sum()
    smooth = np.stack([np.convolve(b, kernel, mode="same") for b in base])
    protos = (smooth - smooth.min()) / (smooth.max() - smooth.min())
    protos = 0.5 + contrast * (protos - 0.5)
    styles = rng.normal(size=(num_classes, dim, rank)) * style
    return protos.astype(np.float32), styles.astype(np.float32)


def make_mnist_like(*, seed: int, train_per_class: int, test_per_class: int, dim: int = 784,
                    num_classes: int = 10, rank: int = 8, noise: float = 0.25,
                    contrast: float = 0.4, style: float = 0.25) -> Dataset:
    """``train_per_class`` and ``test_per_class`` samples of every class,
    shuffled, drawn from ``seed`` (any non-negative integer)."""
    protos, styles = _prototypes(num_classes, dim, rank, contrast, style)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))

    def sample(per_class: int):
        xs, ys = [], []
        for c in range(num_classes):
            z = rng.standard_normal((per_class, rank), dtype=np.float32)
            x = rng.standard_normal((per_class, dim), dtype=np.float32)
            x *= noise
            x += protos[c][None]
            x += z @ styles[c].T
            xs.append(np.clip(x, 0.0, 1.0, out=x))
            ys.append(np.full(per_class, c, dtype=np.int64))
        x = np.concatenate(xs)
        y = np.concatenate(ys)
        perm = rng.permutation(len(y))
        return x[perm], y[perm]

    x_tr, y_tr = sample(train_per_class)
    x_te, y_te = sample(test_per_class)
    return Dataset(x_tr, y_tr, x_te, y_te)
