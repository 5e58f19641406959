"""The card's milliseconds a round in an LM cohort's local step: the
``device_ms`` of the program's ``piece.replay`` spans of the piece ``local``
(CUDA events around each replay of the local step's graph: every member's
forward, recompute, backward and SGD update), the median over two further
calls of the cell with spans on (``bench/kinds/lm.py``)."""

from bench.kinds import lm


def read(ctx):
    return lm.replay_ms(ctx, "local")
