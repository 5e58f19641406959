"""Checkpoints in the reference's npz format (``repro/checkpoint/ckpt.py``),
so a checkpoint written by either package loads in the other.

The format: one npz member per leaf, keyed by the ``/``-joined path of dict
keys, list indices and ``.``-prefixed NamedTuple fields (an optimizer state's
``.mu``, say, as JAX names a NamedTuple's attribute); a bf16 leaf is stored as its ``uint16`` bit pattern,
beside a ``__bf16__<key>`` marker; ``__meta__`` holds a JSON object whose
``step`` is the saved step (the reference also writes its treedef there,
which neither package reads). ``None`` leaves hold nothing.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

__all__ = ["save", "restore", "restore_subtree"]

PyTree = Any

_SEP = "/"


def _items(tree: PyTree, prefix: tuple[str, ...] = ()):
    """(path, leaf) pairs in the reference's order (dict keys sorted)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif _is_namedtuple(tree):
        for k, v in zip(tree._fields, tree):
            yield from _items(v, prefix + (f".{k}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    else:
        yield prefix, tree


def save(path: str, tree: PyTree, *, step: int | None = None) -> None:
    """Write ``tree`` (nested dicts/lists of tensors) to ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat: dict[str, np.ndarray] = {}
    for pth, leaf in _items(tree):
        key = _SEP.join(pth)
        t = torch.as_tensor(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            flat[key] = t.view(torch.int16).numpy().view(np.uint16)
            flat[f"__bf16__{key}"] = np.asarray(True)
        else:
            flat[key] = t.numpy()
    np.savez(path, __meta__=json.dumps({"step": step}), **flat)


def _load(data, key: str, like: torch.Tensor, device=None) -> torch.Tensor:
    arr = data[key]
    if f"__bf16__{key}" in data.files:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"shape mismatch at {key}: {tuple(t.shape)} vs {tuple(like.shape)}")
    return t.to(device=like.device if device is None else device, dtype=like.dtype)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _fill(like: PyTree, fn, prefix: tuple[str, ...] = ()) -> PyTree:
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _fill(v, fn, prefix + (str(k),)) for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_fill(v, fn, prefix + (f".{k}",))
                            for k, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        return [_fill(v, fn, prefix + (str(i),)) for i, v in enumerate(like)]
    return fn(_SEP.join(prefix), like)


def _open(path: str):
    if not path.endswith(".npz"):
        path += ".npz"
    data = np.load(path, allow_pickle=False)
    return path, data, json.loads(str(data["__meta__"]))


def restore(path: str, like: PyTree, *,
            device: str | torch.device | None = None) -> tuple[PyTree, int | None]:
    """Restore into the structure of ``like``: each leaf takes the shape,
    dtype and device of ``like``'s leaf (shapes must match). ``device``
    places every leaf there instead, so ``like`` may live on ``meta``."""
    _, data, meta = _open(path)
    return _fill(like, lambda key, leaf: _load(data, key, leaf, device)), meta.get("step")


def restore_subtree(path: str, like: PyTree, *, prefix: str,
                    device: str | torch.device | None = None) -> tuple[PyTree, int | None]:
    """Restore one top-level subtree (e.g. ``prefix="params"``) of a saved
    tree into the structure of ``like``. An npz loads lazily, so the other
    subtrees (an optimizer's moments) are never read. ``device`` places the
    leaves (default: each ``like`` leaf's device), so ``like`` may live on
    the ``meta`` device and cost no memory."""
    path, data, meta = _open(path)

    def one(key: str, leaf: torch.Tensor) -> torch.Tensor:
        key = _SEP.join([prefix, key]) if key else prefix
        if key not in data.files:
            raise KeyError(
                f"{key!r} not in checkpoint {path} — available top-level "
                f"prefixes: {sorted({f.split(_SEP)[0] for f in data.files if not f.startswith('__')})}"
            )
        return _load(data, key, leaf, device)

    return _fill(like, one), meta.get("step")
