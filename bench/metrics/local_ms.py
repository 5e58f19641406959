"""The card's milliseconds a round in the local steps: the ``device_ms`` of
the program's ``piece.replay`` spans of the piece ``local`` (CUDA events
around each replay of the local steps' graph), the median over the span
calls' replays (``bench/spans.py``); on several shards, the slowest
shard's median, since the round waits for it. The start event is recorded
before the host issues the replay, so on a card that waits for the host
the reading runs from the replay's issue to its end: it holds the graph's
launch latency besides its kernels."""

import statistics
from collections import defaultdict

from bench import spans


def read(ctx):
    runs = spans.calls(ctx)
    if runs is None:
        return None
    by_shard = defaultdict(list)
    for c in runs:
        for s in c.spans:
            if s.name == "piece.replay" and s.attrs.get("piece") == "local":
                by_shard[s.attrs.get("shard", 0)].append(s.attrs["device_ms"])
    if not by_shard:
        return None
    return max(statistics.median(v) for v in by_shard.values())
