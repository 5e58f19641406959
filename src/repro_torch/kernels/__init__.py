"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``LAUNCHES`` counts, per kernel, the launches of the CUDA kernel itself: a
wrapper adds one where it launches and nowhere else (a CPU tensor takes the
plain version and counts nothing). A run resets the counts to read how often
its path went through each kernel.
"""

from __future__ import annotations

LAUNCHES: dict[str, int] = {"gossip_mix": 0}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
