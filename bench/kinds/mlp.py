"""The paper's kind of run: DecAvg over MLP members on MNIST-like data,
through ``DecentralizedTrainer.run_fused``.

The trainer is built as ``experiments.runner`` builds one for a spec: each
call is one spec's run of the traffic's ``rounds_per_call`` rounds at its
``eval_every``, with its staging and CUDA-graph capture; the state carries
from call to call and each call draws fresh batches (``NodeLoader``'s
``index_fn``). Set-up ends with one such call, call 0, whose rounds up to
the traffic's ``check_round`` the reference (``bench/reference/decavg.py``)
replays afterwards: the state at that round, and the evaluation records up
to its ``records_round``. Five numbers compare what the two end with:

- ``param_change``: for each layer's weights and biases (a leaf), the gap
  between the program's norm of the change over the call, ||P_end - P_0||,
  and the reference's, as a share of the reference's norm of that leaf or
  of the median leaf, whichever is larger; the worst leaf.
- ``momentum``: the same of each leaf's momentum at the call's end.
- ``acc``: the widest gap in one node's test accuracy, over every
  evaluated round of the call.
- ``g2_spread``: the widest gap in ``g2_acc_spread``, the G2 accuracy
  averaged over the nodes that hold no G2 example, over the evaluated
  rounds.
- ``consensus``: the widest gap in a node's distance to the node mean, as a
  share of the reference's largest distance in that round.

Leaves whose reference momentum is under a thousandth of the median leaf's
move by rounding alone; they are left out of the first two numbers.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from bench.harness import Cell, sync
from bench.inputs import Inputs, make_inputs
from bench.reference import decavg as reference

__all__ = ["NUMBERS", "Run", "Side", "setup", "param_count", "evaluated_rounds", "check_round",
           "records_round", "reference_side", "gaps"]

NUMBERS = ("param_change", "momentum", "acc", "g2_spread", "consensus")
_CHUNK = 1 << 24


def param_count(dims: Sequence[int]) -> int:
    """Weights and biases of an MLP with widths ``dims``."""
    return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))


class _Feed:
    """``NodeLoader``'s ``index_fn``: the positions of the current call's
    round, drawn from the run's seed."""

    def __init__(self, inputs: Inputs):
        self.inputs = inputs
        self.call = 0

    def __call__(self, round_: int, steps: int) -> np.ndarray:
        if steps != self.inputs.steps:
            raise RuntimeError(f"the program takes {steps} local steps a round, the "
                               f"algorithm {self.inputs.steps}")
        return self.inputs.positions(self.call, round_)


def build_trainer(cell: Cell, inputs: Inputs, feed: _Feed, devices: list[torch.device]):
    """``DecentralizedTrainer`` as ``experiments.runner`` builds it for the
    cell's spec, handed the benchmark's graph, data, split, first member and
    batch draws."""
    from repro_torch.core import mesh as mesh_mod
    from repro_torch.core.topology import Graph
    from repro_torch.data.loader import NodeLoader
    from repro_torch.train.trainer import DecentralizedTrainer

    cfg, tr = cell.config, cell.traffic
    home = devices[0]
    n = inputs.graph.n
    loader = NodeLoader(inputs.ds.x_train, inputs.ds.y_train, inputs.parts,
                        batch_size=inputs.batch, device=home, index_fn=feed)
    graph = Graph(adj=inputs.graph.adj, blocks=inputs.graph.blocks, name=tr["topology"]["family"])
    params = {"layers": [{k: v.expand(n, *v.shape) for k, v in lay.items()}
                         for lay in inputs.member]}
    backend = tr["backend"]
    mesh = mesh_mod.Mesh(devices, ("data",)) if backend == "sparse_sharded" else None
    trainer = DecentralizedTrainer(
        graph, loader, lr=cfg["lr"], momentum=cfg["momentum"], mix_impl=backend,
        matrix="decavg", sparse_p_chunk=tr.get("sparse_p_chunk"), seed=0,
        in_dim=cfg["in_dim"], hidden=tuple(cfg["hidden"]), num_classes=cfg["num_classes"],
        class_groups=inputs.groups, params=params, mesh=mesh, device=home,
    )
    if not trainer.supports_fused:
        raise RuntimeError(f"backend {trainer.mix_impl!r} has no run_fused")
    return trainer


class Run:
    """The trainer after call 0, the readings of the program's side of call
    0 (``prog``) and the window's calls."""

    def __init__(self, cell: Cell, inputs: Inputs, devices: list[torch.device]):
        tr = cell.traffic
        self.cell, self.inputs, self.devices = cell, inputs, devices
        self.rounds_per_call, self.every = int(tr["rounds_per_call"]), int(tr["eval_every"])
        self.evals_per_call = len(evaluated_rounds(self.rounds_per_call, self.every))
        self.gossip_per_call = self.rounds_per_call  # gossip_every is 1: every round mixes
        self.param_count = param_count(inputs.dims)
        self.feed = _Feed(inputs)
        self.trainer = build_trainer(cell, inputs, self.feed, devices)
        self.prog = self._first_call()

    def _run(self, on_round) -> None:
        ds = self.inputs.ds
        self.trainer.run_fused(self.rounds_per_call, eval_every=self.every, x_test=ds.x_test,
                               y_test=ds.y_test, on_round=on_round)
        sync(self.devices)

    def call(self, on_round=None) -> None:
        self.feed.call += 1
        self._run(on_round)

    def _first_call(self) -> Side:
        """Call 0, read at ``check_round`` and its records up to
        ``records_round``."""
        at, upto = check_round(self.cell), records_round(self.cell)
        records: list = []
        state: list[Side] = []

        def on_round(m) -> None:
            records.append(m)
            if m.round == at and not sharded:
                state.append(read_state())

        def read_state() -> Side:
            t = self.trainer
            return _side(t.params["layers"], t.momentum["layers"], self.inputs,
                         [_record(m) for m in records if m.round <= upto])

        # A sharded run's state shows only once its call has gathered it.
        sharded = self.trainer.mix_impl == "sparse_sharded"
        if sharded and at != self.rounds_per_call - 1:
            raise SystemExit(f"{self.cell.name}: a sharded run's state is read at its last "
                             f"round, not round {at}")
        self._run(on_round)
        prog = read_state() if sharded else state[0]
        sync(self.devices)
        return prog

    def release(self) -> None:
        self.trainer = None

    def compare(self, device: torch.device) -> dict[str, float]:
        return gaps(self.prog, reference_side(self.cell, self.inputs, device))


def setup(cell: Cell, seed: int, devices: list[torch.device],
          lap: Callable[[str], None]) -> Run:
    """The run's inputs from ``seed``, the trainer and call 0."""
    inputs = make_inputs(cell.config, cell.traffic, seed, devices[0])
    lap("inputs")
    run = Run(cell, inputs, devices)
    lap("trainer and call 0")
    return run


def check_round(cell: Cell) -> int:
    """The round of call 0 whose state the reference compares (the
    traffic's ``check_round``): an evaluated round."""
    tr = cell.traffic
    rounds, every = int(tr["rounds_per_call"]), int(tr["eval_every"])
    at = int(tr["check_round"])
    if at not in evaluated_rounds(rounds, every):
        raise SystemExit(f"{cell.name}: check_round {at} is not an evaluated round")
    return at


def records_round(cell: Cell) -> int:
    """The last round of call 0 whose evaluation records are compared, with
    every earlier evaluated round's (the traffic's ``records_round``; by
    default ``check_round``): an evaluated round, not after ``check_round``."""
    tr = cell.traffic
    at = check_round(cell)
    upto = int(tr.get("records_round", at))
    if upto > at or upto not in evaluated_rounds(int(tr["rounds_per_call"]),
                                                 int(tr["eval_every"])):
        raise SystemExit(f"{cell.name}: records_round {upto} is not an evaluated round "
                         f"up to check_round {at}")
    return upto


def evaluated_rounds(rounds: int, every: int) -> list[int]:
    """The rounds of a call that ``run_fused`` evaluates: every
    ``every``-th and the last."""
    return [r for r in range(rounds) if r % every == 0 or r == rounds - 1]


def _norm(x: torch.Tensor, minus: torch.Tensor | None = None) -> float:
    """||x - minus|| (``minus`` broadcast over the node axis) in float64,
    a slice of the node axis at a time so that the transient stays small."""
    x = x.reshape(x.shape[0], -1)
    rows = max(1, _CHUNK // max(1, x.shape[1]))
    total = 0.0
    for lo in range(0, x.shape[0], rows):
        part = x[lo:lo + rows].double()
        if minus is not None:
            part -= minus.reshape(1, -1).double()
        total += float((part * part).sum())
    return total ** 0.5


class Side:
    """One side's readings: per-leaf norms of the change and of the
    momentum, and the evaluated rounds' records."""

    def __init__(self, change: list[float], momentum: list[float], evals: list[dict],
                 spread: np.ndarray):
        self.change = np.asarray(change)
        self.momentum = np.asarray(momentum)
        self.evals = evals
        self.spread = spread

    def g2_spread(self, rec: dict) -> float | None:
        if not self.spread.any():
            return None
        return float(rec["group_acc"][self.spread, 1].mean())


def _leaves(layers: list[dict[str, torch.Tensor]]) -> list[torch.Tensor]:
    return [lay[k] for lay in layers for k in ("w", "b")]


def _side(params_layers, momentum_layers, inputs: Inputs, evals: list[dict]) -> Side:
    """Readings of a state (its ``layers`` list of ``{"w", "b"}``
    node-stacked tensors) and of its evaluation records."""
    change = [_norm(p, q) for p, q in zip(_leaves(params_layers), _leaves(inputs.member))]
    mom = [_norm(m) for m in _leaves(momentum_layers)]
    return Side(change, mom, evals, inputs.spread)


def _record(m) -> dict:
    """A ``RoundMetrics`` record as the reference writes its own."""
    return {"round": m.round, "acc": np.asarray(m.per_node_acc),
            "group_acc": np.asarray(m.group_acc), "consensus": np.asarray(m.consensus)}


def reference_side(cell: Cell, inputs: Inputs, device: torch.device,
                   precision: str = "f32") -> Side:
    """The reference's replay of call 0 up to its ``check_round`` and its
    readings, with the records up to ``records_round``."""
    tr = cell.traffic
    rep = reference.replay(inputs, rounds=check_round(cell) + 1,
                           eval_every=int(tr["eval_every"]), lr=cell.config["lr"],
                           momentum=cell.config["momentum"], device=device, precision=precision)
    upto = records_round(cell)
    return _side(rep.params, rep.momentum, inputs, [e for e in rep.evals if e["round"] <= upto])


def _leaf_gap(got: np.ndarray, want: np.ndarray, keep: np.ndarray) -> float:
    scale = np.maximum(want, np.median(want))
    return float(np.max(np.abs(got - want)[keep] / scale[keep]))


def gaps(prog: Side, ref: Side) -> dict[str, float]:
    """The five numbers, program against reference."""
    if [e["round"] for e in prog.evals] != [e["round"] for e in ref.evals]:
        raise ValueError(f"evaluated rounds differ: {[e['round'] for e in prog.evals]} "
                         f"against {[e['round'] for e in ref.evals]}")
    keep = ref.momentum >= 1e-3 * np.median(ref.momentum)
    acc = g2 = cons = 0.0
    for p, r in zip(prog.evals, ref.evals):
        acc = max(acc, float(np.max(np.abs(p["acc"] - r["acc"]))))
        gp, gr = prog.g2_spread(p), ref.g2_spread(r)
        if gr is not None:
            g2 = max(g2, abs(gp - gr))
        scale = max(float(np.max(r["consensus"])), 1e-30)
        cons = max(cons, float(np.max(np.abs(p["consensus"] - r["consensus"]))) / scale)
    return {
        "param_change": _leaf_gap(prog.change, ref.change, keep),
        "momentum": _leaf_gap(prog.momentum, ref.momentum, keep),
        "acc": acc,
        "g2_spread": g2,
        "consensus": cons,
    }
