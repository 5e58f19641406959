"""The host's milliseconds a halo exchange between shards: the program's
``sharded.exchange`` spans (each gossip round's ``core.mesh`` collectives
and their copies into the receivers' buffers, as the host issues them), the
median over the span calls' gossip rounds (``bench/spans.py``)."""

import statistics

from bench import spans


def read(ctx):
    runs = spans.calls(ctx)
    if runs is None:
        return None
    ms = [s.ms for c in runs for s in c.spans if s.name == "sharded.exchange"]
    return statistics.median(ms) if ms else None
