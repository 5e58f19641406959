"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``LAUNCHES`` counts, per kernel, the launches of the CUDA kernel itself: a
wrapper adds one where it launches and nowhere else (a CPU tensor takes the
plain version and counts nothing). A run resets the counts to read how often
its path went through each kernel.

A wrapper called while a CUDA graph is being captured launches nothing: the
launch is recorded into the graph, and ``count_launch`` adds it to
``CAPTURED`` instead. The graph's owner (``repro_torch.graphs.Staged``) reads
how many launches of each kernel its graph holds and adds them to
``LAUNCHES`` on every replay, which is when the card runs them.
"""

from __future__ import annotations

import torch

LAUNCHES: dict[str, int] = {
    "gossip_mix": 0, "sparse_gossip": 0, "sparse_gossip_blocked": 0, "flash_attention": 0,
    "ell_sum": 0, "selective_scan": 0, "selective_scan_bwd": 0,
}
CAPTURED: dict[str, int] = dict.fromkeys(LAUNCHES, 0)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    """Record one launch of kernel ``name`` on the current CUDA stream."""
    if torch.cuda.is_current_stream_capturing():
        CAPTURED[name] += 1
    else:
        LAUNCHES[name] += 1
