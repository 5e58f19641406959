"""A piece of work run eagerly on the CPU, or captured once as a CUDA graph on
the card and replayed.

``Staged(fn, device)`` on a CUDA device captures ``fn`` into a
``torch.cuda.CUDAGraph`` and each call replays it: the same kernels on the
same addresses, with no Python and no launch overhead per kernel. So ``fn``
must read and write only tensors that outlive it (static buffers), and must
not sync with the host (no ``.item()``, ``.cpu()``, ``nonzero``, or Python
branches on tensor values). A capture that fails raises; nothing falls back
to eager execution. On the CPU each call runs ``fn`` itself.

Kernel launch counts (``repro_torch.kernels.LAUNCHES``) follow the card: a
wrapper called during capture records its launch into the graph and counts
it in ``CAPTURED``; every replay adds those launches to ``LAUNCHES``.

Each capture, replay and CPU run is a span (``repro_torch.spans``:
``piece.capture``, ``piece.replay`` timed on the card, ``piece.eager``)
with the attrs the owner gives (the piece, its shard and period slot).
"""

from __future__ import annotations

import gc
from typing import Callable

import torch

from repro_torch.kernels import CAPTURED, LAUNCHES
from repro_torch.spans import span

__all__ = ["Staged"]


class Staged:
    """``fn`` as a replayable CUDA graph on ``device``, or eager on the CPU.

    ``stream`` is the capture stream (warm ``fn``'s operations up on it
    first: lazy initialisation such as cuBLAS workspaces and autograd's
    cannot happen during capture); graphs that never run at the same time
    may share a memory ``pool``. Capture and replay run on ``device``
    whatever card is current, so ``stream`` and ``pool`` must be that
    card's (one of each a card). ``attrs`` label its spans.
    """

    def __init__(
        self,
        fn: Callable[[], None],
        device: torch.device,
        *,
        stream: torch.cuda.Stream | None = None,
        pool=None,
        attrs: dict | None = None,
    ):
        self.fn = fn
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: dict[str, int] = {}
        self.attrs = attrs or {}
        if device.type != "cuda":
            return
        before = dict(CAPTURED)
        graph = torch.cuda.CUDAGraph()
        # No garbage collection during the capture: a dead cycle holding a
        # CUDA graph would destroy it there, and that breaks the capture.
        # (``torch.cuda.graph`` collects beforehand only when
        # ``torch.compiler.config.force_cudagraph_gc`` is set.)
        gc_was_enabled = gc.isenabled()
        # ``torch.cuda.graph`` and the caching allocator's capture pool read
        # the current device, not the stream's: capture on ``device``.
        with (span("piece.capture", **self.attrs), torch.cuda.device(device),
              torch.cuda.graph(graph, pool=pool, stream=stream)):
            gc.disable()
            try:
                fn()
            finally:
                if gc_was_enabled:
                    gc.enable()
        self.launches = {k: v - before[k] for k, v in CAPTURED.items() if v != before[k]}
        self.graph = graph
        self.device = device

    def __call__(self) -> None:
        if self.graph is None:
            with span("piece.eager", **self.attrs):
                self.fn()
            return
        with span("piece.replay", timed=self.device, **self.attrs), torch.cuda.device(self.device):
            self.graph.replay()  # on the current stream of the capture's card
        for name, n in self.launches.items():
            LAUNCHES[name] += n
