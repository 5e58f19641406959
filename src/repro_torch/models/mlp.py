"""The paper's local model: a 3-hidden-layer MLP (512, 256, 128) with ReLU.

Parameters are node-stacked, ``{"layers": [{"w": (N, in, out), "b": (N,
out)}, ...]}``, and the forward pass is one batched product per layer over
the node axis (``torch.baddbmm``), in place of the reference's ``vmap``.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

PyTree = Any

HIDDEN = (512, 256, 128)

__all__ = ["HIDDEN", "init_mlp", "mlp_forward"]


def init_mlp(
    generator: torch.Generator,
    in_dim: int = 784,
    hidden: Sequence[int] = HIDDEN,
    num_classes: int = 10,
    dtype: torch.dtype = torch.float32,
) -> PyTree:
    """He-initialised weights and zero biases for one node, drawn from
    ``generator`` (whose device the tensors are made on)."""
    dims = [in_dim, *hidden, num_classes]
    device = generator.device
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn((a, b), generator=generator, device=device) * (2.0 / a) ** 0.5
        layers.append({"w": w.to(dtype), "b": torch.zeros((b,), dtype=dtype, device=device)})
    return {"layers": layers}


def mlp_forward(params: PyTree, x: torch.Tensor) -> torch.Tensor:
    """Node-stacked params; x: (N, B, in_dim), or (B, in_dim) shared by every
    node -> logits (N, B, num_classes)."""
    layers = params["layers"]
    h = x if x.dim() == 3 else x.expand(layers[0]["w"].shape[0], *x.shape)
    for i, p in enumerate(layers):
        h = torch.baddbmm(p["b"].unsqueeze(1), h, p["w"])
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h
