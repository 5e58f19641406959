"""The host's milliseconds a ``run_fused`` call spends re-staging its rounds:
its program's spans ``fused.program``, ``fused.stage``, ``piece.eager``,
``piece.capture``, ``fused.gather`` and ``fused.close`` summed over the
call, the median over the span calls (``bench/spans.py``)."""

import statistics

from bench import spans


def read(ctx):
    runs = spans.calls(ctx)
    if not runs:
        return None
    return statistics.median(c.restage_ms() for c in runs)
