"""CUDA graphs captured a ``run_fused`` call: the program's ``piece.capture``
spans over the span calls (``bench/spans.py``), over their number."""

from bench import spans


def read(ctx):
    runs = spans.calls(ctx)
    if not runs:
        return None
    return sum(c.captures for c in runs) / len(runs)
