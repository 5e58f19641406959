"""The program's own spans (``repro_torch.spans``) over further calls of the
cell's traffic, for the per-layer metrics that read them.

Once per traced run, after the window and the other readers, spans are
turned on and ``run_fused`` is called on the cell's trainer as the window
calls it (fresh batch draws each call): at least ``MIN_CALLS`` calls, and
more while they fit in ``BUDGET_S`` seconds, each ending in a synchronize of
every card. One more call runs with spans on under ``torch.profiler``, as
the harness's traced call does, and standard error gets that call's idle
seconds by the innermost program span, then one line a call of the spans'
host milliseconds. The result is kept on the reader context, so every
reader shares the same calls.

Nothing is read off the card (no device figure comes from the CPU), nor
where the program has no spans: ``calls`` returns None then.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

from bench import trace

__all__ = ["Call", "calls", "idle_by_span"]

MIN_CALLS = 3
BUDGET_S = 10.0
MEMO = "spans: calls"  # a key no metric can have
# The host's work a call repeats that a call without re-staging would not:
# building the program and the staged rounds, the eager runs and captures,
# the sharded gather, and releasing the graphs.
RESTAGE = ("fused.program", "fused.stage", "piece.eager", "piece.capture", "fused.gather",
           "fused.close")
_SHOWN = ("fused.call", *RESTAGE, "fused.chunk", "piece.replay", "sharded.exchange",
          "trainer.eval", "eval.test_set")


class Call:
    """The finished spans of one ``run_fused`` call."""

    def __init__(self, spans: list):
        self.spans = spans

    @property
    def captures(self) -> int:
        """The CUDA graphs the call captured: its ``piece.capture`` spans."""
        return sum(s.name == "piece.capture" for s in self.spans)

    def host_ms(self, name: str) -> float:
        """Host milliseconds in the spans named ``name``."""
        return sum(s.ms for s in self.spans if s.name == name)

    def restage_ms(self) -> float:
        return sum(self.host_ms(n) for n in RESTAGE)

    def line(self) -> str:
        parts = []
        for name in _SHOWN:
            k = sum(s.name == name for s in self.spans)
            if k:
                parts.append(f"{name} {self.host_ms(name):.3f} ms" + (f" x{k}" if k > 1 else ""))
        return ", ".join(parts) + f"; restage {self.restage_ms():.3f} ms; captures {self.captures}"


def calls(ctx) -> list[Call] | None:
    """The span calls of this traced run (run once, then kept)."""
    if MEMO not in ctx._memo:
        ctx._memo[MEMO] = _run(ctx)
    return ctx._memo[MEMO]


def _run(ctx) -> list[Call] | None:
    if ctx.devices[0].type != "cuda":
        return None
    try:
        from repro_torch import spans
    except ImportError as e:
        print(f"spans: no reading, the program has no spans: {e}", file=sys.stderr)
        return None
    tr, ds, traffic = ctx.trainer, ctx.inputs.ds, ctx.cell.traffic
    feed = tr.loader.index_fn
    rounds, every = int(traffic["rounds_per_call"]), int(traffic["eval_every"])

    def call() -> None:
        feed.call += 1
        tr.run_fused(rounds, eval_every=every, x_test=ds.x_test, y_test=ds.y_test)
        ctx.sync()

    out: list[Call] = []
    spans.take()
    spans.enable()
    try:
        t0 = time.perf_counter()
        walls = []
        while len(out) < MIN_CALLS or time.perf_counter() - t0 + walls[-1] <= BUDGET_S:
            t = time.perf_counter()
            call()
            walls.append(time.perf_counter() - t)
            out.append(Call(spans.take()))
        events: list = []
        with trace.traced(events):
            call()
        profiled = spans.take()
    finally:
        spans.disable()
    summ = idle_by_span(events[0], {s.name for s in profiled})
    print(f"spans profiled call {summ.window_s:.4f} s, idle s by span: "
          + ", ".join(f"{name} {sec:.4f}" for name, sec in summ.idle_gaps), file=sys.stderr)
    for k, c in enumerate(out):
        print(f"spans call {k}: {c.line()}", file=sys.stderr)
    med = statistics.median(walls)
    base = ctx.window["median_call_s"]
    # The two sides differ: these calls follow the traced call, after which
    # the profiler's hooks slow the host.
    print(f"spans on, after the traced call: median call {med:.4f} s ({rounds / med:.4f} "
          f"rounds/s) over {len(out)} calls; the window's, spans off: {base:.4f} s "
          f"({rounds / base:.4f} rounds/s)", file=sys.stderr)
    return out


def idle_by_span(events, names: set[str]) -> trace.Summary:
    """The traced call's summary with its idle gaps (a card running
    nothing, summed over the cards) named after the innermost program span
    (one of ``names``) open at each gap's midpoint, ``bench.window`` where
    none is: the other host events are left out."""
    cpu, keep = torch.autograd.DeviceType.CPU, names | {trace.SPAN}
    # A host-bound call holds a million or more events: one accessor call
    # for each device event, two for each host event.
    return trace.summarize([ev for ev in events
                            if ev.device_type() != cpu or ev.name() in keep])
