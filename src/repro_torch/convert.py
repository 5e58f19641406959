"""Parameter trees between the JAX reference's layout and the port's.

Both packages keep node-stacked parameters as ``{"layers": [{"w": (N, in,
out), "b": (N, out)}, ...]}``; the reference holds the layers in a tuple of
JAX arrays, the port in a list of tensors. Given the reference's tree as
numpy arrays, ``params_from_numpy`` builds the port's, so both packages can
compute from the same weights.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["params_from_numpy", "params_to_numpy"]


def params_from_numpy(tree: Any, device: str | torch.device) -> Any:
    """dict/list/tuple tree of arrays -> the same tree of tensors on ``device``
    (tuples become lists)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.as_tensor(np.array(tree), device=device)


def params_to_numpy(tree: Any) -> Any:
    """The port's tree of tensors -> the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()
