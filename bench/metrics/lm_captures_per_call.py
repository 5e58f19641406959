"""CUDA graphs an LM cohort's ``run_fused`` call captures: the program's
``piece.capture`` spans over two further calls of the cell with spans on,
over their number (``bench/kinds/lm.py``)."""

from bench.kinds import lm


def read(ctx):
    return lm.captures_per_call(ctx)
