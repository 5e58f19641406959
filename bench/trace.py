"""The device trace of a traced window, read from ``torch.profiler``
(CUPTI): each card's busy time, the kernels that took most of it, and the
idle gaps by what the host was doing.

The traced window is the span ``bench.window`` that the harness records
around the work it traces; every device interval is clipped to it. A card's
busy time is the union of its kernel, copy and set intervals (the span's
mirror on the device's timeline is no work). An idle gap is
a stretch of the span in which a card ran nothing; what of it falls inside a
CUDA graph capture is named so, and the rest after the innermost host-side
event running at its midpoint. A trace with no device
activity reads as no busy time: nothing falls back to the host's clock.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

__all__ = ["Summary", "summarize", "traced"]

SPAN = "bench.window"
CAPTURE = "CUDA graph capture (host recording the graph)"
_TOP = 10


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: dict[int, float]  # card index -> seconds busy in the span
    device_ops: list[list]  # [[kernel name, seconds], ...], the longest first
    idle_gaps: list[list]  # [[host activity, seconds], ...], the longest first

    def mean_busy_s(self, cards: int) -> float:
        return sum(self.busy_s.get(c, 0.0) for c in range(cards)) / cards


def _union(starts: np.ndarray, ends: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, len(s) - 1)
    return s[first], reach[last]


def _label_gaps(mid: np.ndarray, cpu_s: np.ndarray, cpu_e: np.ndarray,
                names: list[str]) -> list[str]:
    """The innermost host event covering each midpoint: of those that cover
    it, the one that began last."""
    order = np.argsort(cpu_s, kind="stable")
    s, e = cpu_s[order], cpu_e[order]
    at = np.searchsorted(s, mid, side="right") - 1
    label = np.full(len(mid), -1)
    todo = np.ones(len(mid), dtype=bool)
    for back in range(64):
        cand = at - back
        ok = todo & (cand >= 0)
        hit = ok.copy()
        hit[ok] = e[cand[ok]] >= mid[ok]
        label[hit] = order[cand[hit]]
        todo &= ~hit
        if not todo.any():
            break
    return [names[i] if i >= 0 else "host (no event)" for i in label]


def summarize(events) -> Summary:
    span = [ev for ev in events
            if ev.name() == SPAN and ev.device_type() == torch.autograd.DeviceType.CPU]
    if not span:
        raise RuntimeError(f"trace holds no {SPAN!r} span")
    t0, t1 = span[0].start_ns(), span[0].end_ns()
    # Host-side annotations are mirrored on the device's timeline; they are
    # no work there.
    marks = {SPAN} | {ev.name() for ev in events
                      if getattr(ev, "is_user_annotation", lambda: False)()}
    dev: dict[int, list[tuple[int, int]]] = {}
    kern: dict[str, float] = {}
    cpu_s, cpu_e, cpu_names = [], [], []
    capture: list[list[int]] = []  # [begin, end] of each CUDA graph capture
    for ev in events:
        kind = ev.device_type()
        s, d = ev.start_ns(), ev.duration_ns()
        if kind == torch.autograd.DeviceType.CUDA:
            if ev.name() in marks:
                continue
            a, b = max(s, t0), min(s + d, t1)
            if b > a:
                dev.setdefault(ev.device_index(), []).append((a, b))
                name = ev.name()
                kern[name] = kern.get(name, 0.0) + (b - a) / 1e9
        elif kind == torch.autograd.DeviceType.CPU and not ev.is_async():
            cpu_s.append(s)
            cpu_e.append(s + d)
            cpu_names.append(ev.name())
            if ev.name().startswith("cudaStreamBeginCapture"):
                capture.append([s, t1])
            elif ev.name().startswith("cudaStreamEndCapture") and capture:
                capture[-1][1] = s + d
    busy: dict[int, float] = {}
    gap_s, gap_e = [], []
    for card, iv in dev.items():
        arr = np.asarray(iv, dtype=np.int64)
        us, ue = _union(arr[:, 0], arr[:, 1])
        busy[card] = float((ue - us).sum()) / 1e9
        edges_s = np.concatenate([[t0], ue])
        edges_e = np.concatenate([us, [t1]])
        keep = edges_e > edges_s
        gap_s.append(edges_s[keep])
        gap_e.append(edges_e[keep])
    idle: dict[str, float] = {}
    if gap_s and cpu_s:
        gs, ge = np.concatenate(gap_s), np.concatenate(gap_e)
        # What of a gap falls inside a graph capture is the host recording
        # the graph's operations; the rest goes by the midpoint's event.
        held = np.zeros(len(gs), dtype=np.int64)
        for a, b in sorted(capture):
            held += np.clip(np.minimum(ge, b) - np.maximum(gs, a), 0, None)
        if len(capture):
            idle[CAPTURE] = float(held.sum()) / 1e9
        labels = _label_gaps((gs + ge) // 2, np.asarray(cpu_s, dtype=np.int64),
                             np.asarray(cpu_e, dtype=np.int64), cpu_names)
        for lab, dur in zip(labels, (ge - gs - held) / 1e9):
            if dur > 0:
                idle[lab] = idle.get(lab, 0.0) + float(dur)
    top = lambda d: [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:_TOP]]  # noqa: E731
    return Summary((t1 - t0) / 1e9, busy, top(kern), top(idle))


@contextlib.contextmanager
def traced(out: list):
    """Profile the block (host and CUDA activity) inside the ``bench.window``
    span; appends its events (``summarize`` reads them) to ``out`` once the
    block is done. The block ends with every card synchronized."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SPAN):
            yield
    out.append(prof.profiler.kineto_results.events())
