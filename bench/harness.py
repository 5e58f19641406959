"""One run of one cell: set-up, the timed window, the per-layer readings of a
traced run, and the comparison with the plain reference.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in the file the manifest names, its
traffic in ``bench/traffic/<traffic>.json``, what its configuration's kind
of run needs in ``bench/kinds/<kind>.py`` (``bench/kinds/__init__.py`` says
what such a module holds), its per-layer metrics in
``bench/metrics/<metric>.py`` (each a ``read(ctx)`` that returns a number,
or None where it finds nothing to read) and its limits in
``bench/limits/<cell>.json``.

Set-up is the kind's: it makes the inputs from the seed, builds the program
and runs call 0, which the kind's reference replays once the window has
closed. The window repeats the kind's call, each on fresh draws.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from bench import check, counts, trace

__all__ = ["ROOT", "FORBIDDEN", "Cell", "Context", "load_cell", "load_kind", "run"]

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict[str, Any]
    traffic: dict[str, Any]
    per_layer: dict[str, str]  # the cell's per-layer metrics and their units
    end_to_end: dict[str, str]  # the cell's end-to-end metrics and their units


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load_cell(name: str, *, root: Path = ROOT, overrides: dict | None = None) -> Cell:
    """The cell ``name`` of ``root``'s manifest, with its configuration and
    traffic (``overrides`` merged into the traffic, for tests at a small
    size)."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r}; one of {sorted(cells)}")
    w = cells[name]
    (conf,) = [c for c in manifest["configs"] if c["name"] == w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
    per_layer, end_to_end = ({m["name"]: m["unit"] for m in manifest[section]
                              if "workloads" not in m or name in m["workloads"]}
                             for section in ("per_layer", "end_to_end"))
    return Cell(name, int(w["chips"]), config, _merge(traffic, overrides or {}), per_layer,
                end_to_end)


@dataclasses.dataclass
class Context:
    """What a per-layer reader may read."""

    cell: Cell
    inputs: Any
    trainer: Any
    devices: list[torch.device]
    window: dict[str, float]  # seconds, rounds, calls, evals, gossip_rounds, median_call_s
    trace: trace.Summary | None
    wire: dict[str, int]  # bytes between shards over the window, by kind
    peaks: dict | None
    param_count: int | None = None  # the program's parameters a node
    _memo: dict = dataclasses.field(default_factory=dict)

    def value(self, metric: str) -> float | None:
        """Another per-layer metric's reading, read once."""
        if metric not in self._memo:
            self._memo[metric] = _reader(metric)(self)
        return self._memo[metric]

    def sync(self) -> None:
        sync(self.devices)


def _reader(metric: str) -> Callable[[Context], float | None]:
    path = ROOT / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_kind(cell: Cell, root: Path = ROOT):
    """The module of the cell's configuration kind, ``bench/kinds/<kind>.py``
    under ``root``."""
    kind = cell.config["kind"]
    path = root / "bench" / "kinds" / f"{kind}.py"
    if not path.is_file():
        raise SystemExit(f"{cell.name}: no module bench/kinds/{kind}.py for the kind of "
                         f"configuration {kind!r}")
    spec = importlib.util.spec_from_file_location("bench_kind_" + kind, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


class _Laps:
    """Seconds between successive points of a run, for standard error."""

    def __init__(self, t0: float):
        self.t = t0
        self.times: list[tuple[str, float]] = []

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.times.append((name, now - self.t))
        self.t = now


def sync(devices: list[torch.device]) -> None:
    """Wait for every card among ``devices``."""
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _loaded_forbidden() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _peak_bytes(devices: list[torch.device]) -> int:
    return max((torch.cuda.max_memory_allocated(d) for d in dict.fromkeys(devices)
                if d.type == "cuda"), default=0)


def run(name: str, *, seed: int, seconds: float, traced: bool, t_start: float,
        device: str = "cuda", overrides: dict | None = None, root: Path = ROOT) -> dict[str, Any]:
    """One run of cell ``name`` of ``root``'s manifest; returns the result
    line's object. With ``device="cpu"`` (tests) the cell's shards all sit
    on the CPU."""
    cell = load_cell(name, root=root, overrides=overrides)
    kind = load_kind(cell, root)
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"{cell.name} needs {cell.chips} CUDA card(s); "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                             f"available")
        devices = [torch.device("cuda", i) for i in range(cell.chips)]
        for d in devices:
            torch.cuda.synchronize(d)  # the card's context, before its counters
            torch.cuda.reset_peak_memory_stats(d)
    else:
        devices = [torch.device("cpu")] * cell.chips
    import repro_torch.device  # noqa: F401  (TF32 off, as the program states)
    from repro_torch.core import mesh as mesh_mod

    laps = _Laps(t_start)
    laps.lap("imports and CUDA")
    program = kind.setup(cell, seed, devices, laps.lap)
    setup_s = time.perf_counter() - t_start

    mesh_mod.reset_wire_bytes()
    n_calls = 0
    ends: list[float] = []
    t0 = time.perf_counter()
    while True:
        program.call()
        n_calls += 1
        ends.append(time.perf_counter())
        if n_calls == 1:
            # What one spec's run needs: set-up and one call of the window,
            # whatever number of calls the window holds.
            run_peak = _peak_bytes(devices)
        if ends[-1] - t0 >= seconds:
            break
    window_s = ends[-1] - t0
    per_call = np.diff([t0, *ends])
    laps.lap(f"window ({n_calls} calls)")
    wire = mesh_mod.wire_bytes()
    peak = _peak_bytes(devices)
    events: list = []
    if traced:  # one more call, traced, once the window has closed
        with trace.traced(events):
            program.call()
        laps.lap("traced call")

    window = {"seconds": window_s, "rounds": n_calls * program.rounds_per_call,
              "calls": n_calls, "evals": n_calls * program.evals_per_call,
              "gossip_rounds": n_calls * program.gossip_per_call,
              "median_call_s": float(np.median(per_call))}
    card = torch.cuda.get_device_name(devices[0]) if devices[0].type == "cuda" else "cpu"
    dev_info: dict[str, Any] = {"platform": "gpu" if devices[0].type == "cuda" else "cpu",
                                "kind": card, "count": cell.chips, "memory_peak_bytes": peak}
    breakdown = None
    if traced:
        summ = trace.summarize(events[0])
        ctx = Context(cell, program.inputs, program.trainer, devices, window, summ, wire,
                      counts.peaks_for(card), program.param_count)
        metrics = {}
        for m, unit in cell.per_layer.items():
            v = ctx.value(m)
            if v is not None:
                metrics[m] = {"value": float(v), "unit": unit}
        dev_info["busy_s"] = summ.mean_busy_s(cell.chips)
        dev_info["window_s"] = summ.window_s
        breakdown = {"device_ops": summ.device_ops, "idle_gaps": summ.idle_gaps}
        del ctx
    else:
        taken = {"rounds_per_s": window["rounds"] / window_s,
                 "peak_mem_gib": run_peak / 2**30, "setup_s": setup_s}
        metrics = {m: {"value": taken[m], "unit": unit} for m, unit in cell.end_to_end.items()}

    # The program's state goes before the reference runs on the same cards.
    program.release()
    gc.collect()
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()
    laps.lap("per-layer readings" if traced else "after the window")
    numbers = program.compare(devices[0])
    laps.lap("reference")
    print("phases " + ", ".join(f"{k} {v:.3f} s" for k, v in laps.times), file=sys.stderr)
    print(f"calls {len(per_call)}: min {per_call.min():.4f} s, median {np.median(per_call):.4f} s, "
          f"max {per_call.max():.4f} s; first {per_call[0]:.4f} s", file=sys.stderr)
    print("call seconds " + " ".join(f"{t:.4f}" for t in per_call), file=sys.stderr)
    print(f"peak {run_peak} B after the window's first call, {peak} B at its end", file=sys.stderr)
    if traced:
        print(f"traced call {summ.window_s:.4f} s, busy {summ.mean_busy_s(cell.chips):.4f} s "
              f"(mean over the cards)", file=sys.stderr)
    correct, checked = check.judge(numbers, check.load_limits(root, cell.name))
    for k in kind.NUMBERS:
        if k not in checked:
            print(f"check {k} {numbers[k]:.6e} not compared (no limit)", file=sys.stderr)
    for k, v in checked.items():
        print(f"check {k} {v['value']:.6e} limit {v['limit']:.6e}", file=sys.stderr)
    bad = _loaded_forbidden()
    if bad:
        raise SystemExit(f"modules of the JAX package or JAX loaded: {', '.join(bad)}")
    out: dict[str, Any] = {"correct": correct, "attempted": window["rounds"], "failed": 0,
                           "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["numbers"] = numbers
    out["checked"] = checked
    return out

