"""Operations and bytes a DecAvg round needs, from its shapes: the
yardstick of ``round_mfu`` and ``mix_roofline_pct``.

Model FLOPs count what the algorithm needs, not what an implementation
computes: a local step is 6 P B per node (forward 2 P B, backward 4 P B), an
evaluation 2 P T per node, and the mix 2 nnz(W) P, a multiply and an add for
each nonzero of W and each parameter, whether the mix runs as a dense
product or over W's nonzeros.

The mix's bytes are each node's parameters read once and written once in
f32, and each nonzero of W once as an f32 value and an int32 column.
"""

from __future__ import annotations

import json
from pathlib import Path

__all__ = ["sgd_flops", "eval_flops", "mix_flops", "mix_bytes", "window_flops",
           "peaks_for"]

F32 = 4
INDEX = 4


def sgd_flops(p: int, batch: int, steps: int, n: int) -> int:
    """One round's local steps over every node."""
    return 6 * p * batch * steps * n


def eval_flops(p: int, test: int, n: int) -> int:
    """One evaluation of every node on the test set."""
    return 2 * p * test * n


def mix_flops(nnz: int, p: int) -> int:
    return 2 * nnz * p


def mix_bytes(n: int, p: int, nnz: int) -> int:
    return 2 * n * p * F32 + nnz * (F32 + INDEX)


def window_flops(*, p: int, batch: int, steps: int, n: int, test: int, nnz: int, rounds: int,
                 evals: int, gossip_rounds: int) -> int:
    """Model FLOPs of ``rounds`` rounds with ``evals`` evaluations and
    ``gossip_rounds`` mixes."""
    return (rounds * sgd_flops(p, batch, steps, n) + evals * eval_flops(p, test, n)
            + gossip_rounds * mix_flops(nnz, p))


def peaks_for(kind: str) -> dict | None:
    """The published peaks of the card named ``kind`` (``peaks.json``), or
    None for a card the table does not hold."""
    table = json.loads((Path(__file__).parent / "peaks.json").read_text())["cards"]
    return table.get(kind)
