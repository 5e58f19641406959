"""Spans of the program's own work, kept in memory: where the host's time goes
inside a ``run_fused`` call, and how long each replayed CUDA graph took on
its card.

``span(name, **attrs)`` is a context manager around one piece of work. Spans
are off by default; ``enable()`` turns them on and ``take()`` drains the
finished ones. A span records its name, an id, its parent's id (the span
open around it: the host drives the card from one thread, so a stack), its
start and end and its attrs (round, shard, piece, period slot). Start and
end are ``time.time_ns()``: the Unix-epoch nanoseconds that
``torch.profiler``'s kineto events carry, so the two can be read side by
side.

``span(name, timed=device)`` on a CUDA ``device`` also records a pair of
CUDA events on that card's current stream around the block, while spans are
on and the stream is not capturing; ``take()`` waits for the second event
and turns the pair into the attr ``device_ms``: the card's time from the
first event to the end of the block's work. A card idle before the block
reaches the first event at once, so the host's launch latency counts too.
Only a graph's replay is timed so
(``graphs.Staged``).

Off, ``span()`` costs a flag check and the profiler's check, and returns a
shared null object: it allocates nothing on the card and records no CUDA
event. Whenever ``torch.profiler`` is recording, each span also enters
``torch.profiler.record_function(name)``, on or off, so a profiled call
shows the program's spans on its timeline.

Spans go around pieces of work (a call's staging, a round, a piece's run),
never inside a per-kernel loop.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any

import torch

__all__ = ["Span", "enable", "disable", "enabled", "span", "take"]

_on = False
_ids = itertools.count(1)
_stack: list[int] = []  # ids of the open spans, innermost last
_done: list["Span"] = []


@dataclasses.dataclass
class Span:
    name: str
    id: int
    parent: int | None
    start_ns: int
    end_ns: int
    attrs: dict[str, Any]

    @property
    def ms(self) -> float:
        """The span's length on the host's clock, in milliseconds."""
        return (self.end_ns - self.start_ns) / 1e6


def enable() -> None:
    """Record spans from now on."""
    global _on
    _on = True


def disable() -> None:
    """Record no more spans (those finished stay until ``take``)."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


class _Null:
    """What ``span`` returns while spans are off and no profiler records."""

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_NULL = _Null()


class _Open:
    """A span being recorded."""

    __slots__ = ("name", "attrs", "timed", "id", "parent", "start", "events", "mirror")

    def __init__(self, name: str, attrs: dict[str, Any], timed: torch.device | None):
        self.name, self.attrs, self.timed = name, attrs, timed

    def __enter__(self) -> None:
        self.start = time.time_ns()  # lint: allow[D002] — the profiler's epoch clock, not a duration
        self.mirror = torch.profiler.record_function(self.name) if _profiling() else None
        if self.mirror is not None:
            self.mirror.__enter__()
        self.id = next(_ids)
        self.parent = _stack[-1] if _stack else None
        _stack.append(self.id)
        self.events = None
        dev = self.timed
        if dev is not None and dev.type == "cuda":
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev)
                capturing = torch.cuda.is_current_stream_capturing()
            if not capturing:
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True), stream)
                self.events[0].record(stream)

    def __exit__(self, *exc) -> None:
        attrs = self.attrs
        if self.events is not None:
            self.events[1].record(self.events[2])
            attrs = {**attrs, "_events": self.events[:2]}
        _stack.pop()
        if self.mirror is not None:
            self.mirror.__exit__(*exc)
        end = time.time_ns()  # lint: allow[D002] — the profiler's epoch clock, not a duration
        _done.append(Span(self.name, self.id, self.parent, self.start, end, attrs))


def span(name: str, *, timed: torch.device | None = None, **attrs):
    """A context manager recording the block as the span ``name`` with
    ``attrs``; with ``timed`` a CUDA device, the card's time too (module
    docstring). Off, and with no profiler recording, the shared null
    object."""
    if _on:
        return _Open(name, attrs, timed)
    if _profiling():
        return torch.profiler.record_function(name)
    return _NULL


def take() -> list[Span]:
    """The finished spans, in the order they ended, and forget them. A
    span timed on a card waits for its end event and gets ``device_ms``."""
    out = _done[:]
    _done.clear()
    for s in out:
        events = s.attrs.pop("_events", None)
        if events is not None:
            events[1].synchronize()
            s.attrs["device_ms"] = events[0].elapsed_time(events[1])
    return out
