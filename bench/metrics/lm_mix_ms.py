"""The card's milliseconds of an LM cohort's gossip round: the ``device_ms``
of the program's ``piece.replay`` spans of the pieces ``mix`` (each period
slot's gossip graph: every leaf mixed, ``P <- W P``), the median over two
further calls of the cell with spans on (``bench/kinds/lm.py``)."""

from bench.kinds import lm


def read(ctx):
    return lm.replay_ms(ctx, "mix")
