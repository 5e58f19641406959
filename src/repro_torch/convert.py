"""Parameter trees between the JAX reference's layout and the port's.

Both packages keep parameters as nested dicts (and lists) of arrays with the
same keys and shapes: the node-stacked MLP ``{"layers": [{"w", "b"}, ...]}``
and the LLM tree, whose ``blocks`` leaves carry the leading group axis. The
reference holds JAX arrays (tuples where the port has lists), the port
tensors. Given the reference's tree as numpy arrays, ``params_from_numpy``
builds the port's, so both packages can compute from the same weights;
``params_to_numpy`` goes back.

bf16 leaves travel as their bit patterns: a numpy ``bfloat16`` array (the
``ml_dtypes`` type JAX gives) is viewed as ``uint16`` and the tensor viewed
back as ``torch.bfloat16``, so nothing is rounded either way. ``None``
leaves (empty subtrees, as in the reference's caches) stay ``None``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["params_from_numpy", "params_to_numpy"]


def _tensor(leaf: Any) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def params_from_numpy(tree: Any, device: str | torch.device) -> Any:
    """dict/list/tuple tree of arrays -> the same tree of tensors on ``device``
    (tuples become lists)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return _tensor(tree).to(device)


def params_to_numpy(tree: Any) -> Any:
    """The port's tree of tensors -> the same tree of numpy arrays. bf16
    leaves come back as numpy ``bfloat16``, which needs that type registered
    with numpy (``ml_dtypes``, which JAX imports)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            bf16 = np.dtype("bfloat16")
        except TypeError as err:
            raise TypeError("numpy has no bfloat16 type: import ml_dtypes first") from err
        return t.view(torch.int16).numpy().view(bf16)
    return t.numpy()
