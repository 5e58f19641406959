"""Every input of a run, made from its seed: data, graph, split, the first
member's weights and the batch draws. Both the program and the reference
are handed these same inputs; neither makes its own."""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from bench.inputs import data, draws, graphs, partition

__all__ = ["Inputs", "make_inputs"]


@dataclasses.dataclass
class Inputs:
    seed: int
    ds: data.Dataset
    graph: graphs.Graph
    parts: list[np.ndarray]
    sizes: np.ndarray  # (N,) examples a node
    spread: np.ndarray  # (N,) bool: nodes holding no G2 example
    groups: np.ndarray  # (C,) class -> group (G1 = 0, G2 = 1)
    member: list[dict[str, torch.Tensor]]  # one node's initial layers
    dims: tuple[int, ...]
    batch: int
    steps: int

    def positions(self, call: int, round_: int) -> np.ndarray:
        return draws.batch_positions(self.seed, call, round_, self.sizes, self.steps, self.batch)


def make_inputs(config: dict[str, Any], traffic: dict[str, Any], seed: int,
                device: torch.device) -> Inputs:
    d = traffic["data"]
    ds = data.make_mnist_like(seed=seed, train_per_class=d["train_per_class"],
                              test_per_class=d["test_per_class"], dim=config["in_dim"],
                              num_classes=config["num_classes"])
    graph = graphs.make(traffic["topology"])
    parts = partition.split(traffic["partitioner"], ds.y_train, graph, seed)
    sizes = np.array([len(p) for p in parts], dtype=np.int64)
    dims = (config["in_dim"], *config["hidden"], config["num_classes"])
    groups = np.zeros(config["num_classes"], dtype=np.int64)
    groups[config["num_classes"] // 2:] = 1
    return Inputs(
        seed=seed, ds=ds, graph=graph, parts=parts, sizes=sizes,
        spread=~partition.holds_g2(ds.y_train, parts), groups=groups,
        member=draws.init_member(seed, dims, device), dims=dims,
        batch=traffic["batch"], steps=draws.local_steps(sizes, traffic["batch"]),
    )
