"""The comparison that decides ``correct``.

The set-up's call (call 0, every round of it through the timed path) is
replayed by the reference, and five numbers compare what the two end with:

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

Each cell's limits are in ``bench/limits/<cell>.json``; a number with no
limit there is reported and not compared.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

__all__ = ["NUMBERS", "Side", "program_side", "reference_side", "gaps", "load_limits", "judge"]

NUMBERS = ("param_change", "momentum", "acc", "g2_spread", "consensus")
_CHUNK = 1 << 24


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


def program_side(params_layers, momentum_layers, member, records, spread) -> Side:
    """Readings of the program's state (its ``layers`` list of ``{"w", "b"}``
    node-stacked tensors) and of its ``RoundMetrics`` records."""
    p0 = _leaves(member)
    change = [_norm(p, q) for p, q in zip(_leaves(params_layers), p0)]
    mom = [_norm(m) for m in _leaves(momentum_layers)]
    evals = [{"round": m.round, "acc": np.asarray(m.per_node_acc),
              "group_acc": np.asarray(m.group_acc), "consensus": np.asarray(m.consensus)}
             for m in records]
    return Side(change, mom, evals, spread)


def reference_side(rep, member, spread) -> Side:
    p0 = _leaves(member)
    change = [_norm(p, q) for p, q in zip(_leaves(rep.params), p0)]
    mom = [_norm(m) for m in _leaves(rep.momentum)]
    return Side(change, mom, rep.evals, spread)


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


def load_limits(root: Path, cell: str) -> dict[str, float]:
    path = root / "bench" / "limits" / f"{cell}.json"
    if not path.exists():
        return {}
    return {k: float(v["limit"]) for k, v in json.loads(path.read_text())["limits"].items()}


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict[str, Any]]:
    """``correct`` and each compared number beside its limit. A cell with
    no limits is never correct."""
    checked = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS if k in limits}
    ok = bool(checked) and all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
                               for v in checked.values())
    return ok, checked
