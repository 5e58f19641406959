"""Plain DecAvg (the paper's section 3 and Eq. 1) in PyTorch, float32 with
TF32 off: the reference that decides whether a run is correct.

It takes only the benchmark's inputs (data, graph, split, the first
member's weights, the batch draws) and works out everything else again: the
mixing matrix from the graph and the nodes' data sizes, the local SGD with
momentum, the mix ``P <- W @ P`` and the evaluation records. It imports
nothing of the program.

A round: every node takes ``steps`` local steps of SGD with momentum
(``m = mu * m + g``, ``p = p - lr * m``) on its own batches, the loss being
its mean cross-entropy; then every node's weights become the W-weighted
average over its closed neighbourhood, W's row i holding |D_j| / sum of
|D_k| over the neighbourhood. Momentum is the node's own and is not mixed.

``precision="tf32"`` computes every matrix product in TF32 instead: on a
card by switching TF32 on, on the CPU by rounding each product's operands
to TF32's 10-bit mantissa. It is the control the comparison has to fail.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

__all__ = ["Replay", "mixing_matrix", "replay"]


def mixing_matrix(adj: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """(N, N) float64 W over the closed neighbourhoods, rows summing to 1."""
    closed = adj.astype(np.float64)
    np.fill_diagonal(closed, 1.0)
    w = closed * np.asarray(sizes, dtype=np.float64)[None, :]
    return w / w.sum(axis=1, keepdims=True)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits), gradients passed through."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return x + (r - x).detach()


@dataclasses.dataclass
class Replay:
    """What the reference ends a replay with: each layer's node-stacked
    weights and momentum, and each evaluated round's records."""

    params: list[dict[str, torch.Tensor]]
    momentum: list[dict[str, torch.Tensor]]
    evals: list[dict]  # {"round", "acc" (N,), "group_acc" (N, G), "consensus" (N,)}


class _Model:
    def __init__(self, precision: str, device: torch.device):
        self.emulate = precision == "tf32" and device.type != "cuda"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.emulate:
            a, b = _tf32(a), _tf32(b)
        return torch.matmul(a, b)

    def forward(self, layers: list[dict[str, torch.Tensor]], x: torch.Tensor) -> torch.Tensor:
        h = x
        for i, lay in enumerate(layers):
            h = self.mm(h, lay["w"]) + lay["b"][:, None, :]
            if i < len(layers) - 1:
                h = torch.clamp_min(h, 0.0)
        return h


@contextlib.contextmanager
def _precision(precision: str, device: torch.device):
    if precision not in ("f32", "tf32"):
        raise ValueError(f"precision must be 'f32' or 'tf32', got {precision!r}")
    was = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = precision == "tf32" and device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def _evaluate(model: _Model, params, x_test, y_test, groups, num_groups, block: int) -> dict:
    n = params[0]["w"].shape[0]
    acc, gacc = [], []
    in_group = [(groups[y_test] == g).float() for g in range(num_groups)]
    for lo in range(0, n, block):
        part = [{k: v[lo:lo + block] for k, v in lay.items()} for lay in params]
        x = x_test.expand(part[0]["w"].shape[0], *x_test.shape)
        hit = (model.forward(part, x).argmax(dim=-1) == y_test).float()  # (nb, T)
        acc.append(hit.mean(dim=1))
        gacc.append(torch.stack([(hit * m).sum(dim=1) / m.sum().clamp(min=1.0)
                                 for m in in_group], dim=1))
    sq = torch.zeros(n, dtype=torch.float64, device=x_test.device)
    for lay in params:
        for leaf in lay.values():
            flat = leaf.reshape(n, -1).double()
            sq += ((flat - flat.mean(dim=0, keepdim=True)) ** 2).sum(dim=1)
    return {"acc": torch.cat(acc).cpu().numpy(), "group_acc": torch.cat(gacc).cpu().numpy(),
            "consensus": sq.sqrt().cpu().numpy()}


@torch.no_grad()
def replay(inputs, *, rounds: int, eval_every: int, lr: float, momentum: float,
           device: torch.device, precision: str = "f32", eval_block: int = 512) -> Replay:
    """The set-up's call of ``rounds`` rounds (draws of call 0), evaluated
    on the program's cadence: every ``eval_every``-th round and the last."""
    model = _Model(precision, device)
    n = inputs.graph.n
    x_train = torch.as_tensor(inputs.ds.x_train, device=device)
    y_train = torch.as_tensor(inputs.ds.y_train, device=device)
    x_test = torch.as_tensor(inputs.ds.x_test, device=device)
    y_test = torch.as_tensor(inputs.ds.y_test, device=device)
    groups = torch.as_tensor(inputs.groups, device=device)
    num_groups = int(inputs.groups.max()) + 1
    order = torch.as_tensor(np.concatenate(inputs.parts), device=device)
    start = torch.as_tensor(np.concatenate([[0], np.cumsum(inputs.sizes)[:-1]]), device=device)
    w = torch.as_tensor(mixing_matrix(inputs.graph.adj, inputs.sizes).astype(np.float32),
                        device=device)
    params = [{k: v.expand(n, *v.shape).clone() for k, v in lay.items()} for lay in inputs.member]
    moms = [{k: torch.zeros_like(v) for k, v in lay.items()} for lay in params]
    evals = []
    with _precision(precision, device):
        for r in range(rounds):
            pos = torch.as_tensor(inputs.positions(0, r), device=device)
            for s in range(inputs.steps):
                rows = order[start[:, None] + pos[s]]  # (N, B) example rows
                x, y = x_train[rows], y_train[rows]
                leaves = [t.requires_grad_(True) for lay in params for t in lay.values()]
                with torch.enable_grad():
                    logits = model.forward(params, x)
                    loss = torch.nn.functional.cross_entropy(
                        logits.reshape(-1, logits.shape[-1]), y.reshape(-1), reduction="none",
                    ).view(n, -1).mean(dim=1).sum()
                    grads = torch.autograd.grad(loss, leaves)
                grads = iter(grads)
                for lay, mlay in zip(params, moms):
                    for k in lay:
                        mlay[k] = momentum * mlay[k] + next(grads)
                        lay[k] = lay[k].detach() - lr * mlay[k]
            for lay in params:
                for k, leaf in lay.items():
                    lay[k] = model.mm(w, leaf.reshape(n, -1)).reshape(leaf.shape)
            if r % eval_every == 0 or r == rounds - 1:
                rec = _evaluate(model, params, x_test, y_test, groups, num_groups, eval_block)
                evals.append({"round": r, **rec})
    return Replay(params, moms, evals)
