"""The host's milliseconds an LM cohort's ``run_fused`` call spends
re-staging its rounds: the program's spans ``fused.program``,
``fused.stage``, ``piece.eager``, ``piece.capture`` and ``fused.close``
summed over the call, the median over two further calls of the cell with
spans on (``bench/kinds/lm.py``)."""

from bench.kinds import lm


def read(ctx):
    return lm.restage_ms(ctx)
